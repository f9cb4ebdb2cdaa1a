"""The port's differentiable path (``ops/shade.py`` ``refine_hit``,
``render_rays(differentiable=True)``) against the JAX package's, on the
CPU: the refined hits, the radiance and the gradients of every trainable
field through each engine, finite differences, finite gradients
everywhere, and inverse rendering.

The JAX package's cluster engine runs its Pallas kernels in interpret
mode here, so the ray counts stay at 16x16 to 24x24.  Gradients compare
on the rays whose primitive ids agree between the packages at every
bounce (recorded at ``refine_hit``): elsewhere the two take a different
(equally valid) topology on a float32-ambiguous lane.
"""

import contextlib
import dataclasses
import functools

import numpy as np
import pytest
import torch

from torch_port_util import jax_accel, radiance_outside, shared_inputs

ENGINES = ["brute", "bvh", "cluster"]


def _eye(name, res):
    """(origin (3,), dirs (R, 3)) numpy eye rays of the scene's camera at
    res x res, from the JAX package (raster order)."""
    from raytracer_tpu.ops.camera import eye_rays

    _, meta, _, _ = jax_accel(name)
    cam = dataclasses.replace(meta.cameras[0], width=res, height=res)
    origin, dirs = eye_rays(cam)
    return np.array(origin, np.float32), np.array(dirs, np.float32)


def _accels(name, engine):
    """(JAX accelerator, port accelerator) of ``engine`` for a scene: the
    JAX package's builds, handed to the port."""
    import jax

    from raytracer_tpu_torch.models.bvh import build_bvh, device_bvh

    _, jcs, pdata, pmeta, pcs = shared_inputs(name)
    if engine == "brute":
        return None, None
    if engine == "cluster":
        return jcs, pcs
    _, _, jbvh, _ = jax_accel(name)
    return (jax.device_put(jbvh),
            device_bvh(build_bvh(pdata, pmeta, ordered=True), "cpu"))


@contextlib.contextmanager
def recorded_prims():
    """Record each bounce's primitive ids as both packages' integrators hand
    them to ``refine_hit``: yields {"jax": [...], "port": [...]}."""
    import jax

    from raytracer_tpu.models import whitted as JW
    from raytracer_tpu_torch.models import whitted as PW

    rec = {"jax": [], "port": []}
    jorig, porig = JW.refine_hit, PW.refine_hit

    def jwrap(data, meta, origin, dirs, prim):
        jax.debug.callback(lambda p: rec["jax"].append(np.asarray(p)), prim,
                           ordered=True)
        return jorig(data, meta, origin, dirs, prim)

    def pwrap(data, meta, origin, dirs, prim):
        rec["port"].append(prim.detach().numpy().copy())
        return porig(data, meta, origin, dirs, prim)

    JW.refine_hit, PW.refine_hit = jwrap, pwrap
    try:
        yield rec
    finally:
        JW.refine_hit, PW.refine_hit = jorig, porig


@functools.lru_cache(maxsize=None)
def _radiance_both(name, engine, res):
    """(JAX radiance, port radiance, stable (R,) bool): the differentiable
    forward of both packages on the same eye rays; ``stable`` marks the
    rays whose prim ids agree at every bounce."""
    import jax
    import jax.numpy as jnp

    from raytracer_tpu.models.whitted import render_rays as jrender
    from raytracer_tpu_torch.models.whitted import render_rays as prender

    jdata, _, pdata, pmeta, _ = shared_inputs(name)
    _, meta, _, _ = jax_accel(name)
    jacc, pacc = _accels(name, engine)
    origin, dirs = _eye(name, res)
    with recorded_prims() as rec:
        jc = np.asarray(jrender(jdata, meta, jnp.asarray(origin),
                                jnp.asarray(dirs), bvh=jacc, engine=engine,
                                differentiable=True))
        jax.effects_barrier()
        with torch.no_grad():
            pc = prender(pdata, pmeta, torch.from_numpy(origin),
                         torch.from_numpy(dirs), pacc, engine=engine,
                         differentiable=True).numpy()
    assert len(rec["jax"]) == len(rec["port"]) == meta.max_depth + 1
    stable = np.ones(len(dirs), bool)
    for a, b in zip(rec["jax"], rec["port"]):
        stable &= a == b
    return jc, pc, stable


@pytest.mark.parametrize("name", ["entry", "terrain16", "spheres600"])
def test_refine_hit_matches_jax(name):
    """refine_hit on the same prim ids (misses included): t, normal, point
    and offset to rtol 1e-5, hit and material equal."""
    import jax.numpy as jnp

    from raytracer_tpu.ops.shade import refine_hit as jrefine
    from raytracer_tpu_torch.ops.shade import refine_hit as prefine
    from raytracer_tpu_torch.ops.traverse import brute_closest
    from torch_port_util import scene_rays

    jdata, _, pdata, pmeta, _ = shared_inputs(name)
    _, meta, _, cs = jax_accel(name)
    origin, dirs, _ = scene_rays(cs, 1024, 11)
    prim = brute_closest(pdata, torch.from_numpy(origin),
                         torch.from_numpy(dirs))
    assert 0.2 < float((prim >= 0).float().mean()) < 1.0
    jh = jrefine(jdata, meta, jnp.asarray(origin), jnp.asarray(dirs),
                 jnp.asarray(prim.numpy().astype(np.int32)))
    ph = prefine(pdata, pmeta, torch.from_numpy(origin),
                 torch.from_numpy(dirs), prim)
    np.testing.assert_array_equal(ph.hit.numpy(), np.asarray(jh.hit))
    np.testing.assert_array_equal(ph.mat.numpy(), np.asarray(jh.mat))
    for f in ("t", "normal", "point", "offset"):
        np.testing.assert_allclose(getattr(ph, f).numpy(),
                                   np.asarray(getattr(jh, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)


@pytest.mark.parametrize("name,res", [("entry", 24), ("terrain16", 16)])
@pytest.mark.parametrize("engine", ENGINES)
def test_differentiable_radiance_matches_jax(name, res, engine):
    """render_rays(differentiable=True) through each engine: the radiance
    bar (rtol 1e-4 / atol 1e-3, at most 4 rays outside), and at most 1%
    of the rays take another primitive at some bounce."""
    jc, pc, stable = _radiance_both(name, engine, res)
    assert np.isfinite(pc).all() and pc.max() > 0
    assert radiance_outside(pc, jc) <= 4
    assert stable.mean() > 0.99


def _grads_both(name, engine, res, seed=3):
    """Per-field gradients of sum(radiance * w) over the stable rays, w
    uniform in [0.5, 1), in both packages: ({field: jax grad}, {field:
    port grad}, stable)."""
    import jax
    import jax.numpy as jnp

    from raytracer_tpu.models.whitted import render_rays as jrender
    from raytracer_tpu.parallel.train import apply_params as japply
    from raytracer_tpu.parallel.train import extract_params as jextract
    from raytracer_tpu_torch.models.whitted import render_rays as prender
    from raytracer_tpu_torch.parallel.train import (
        PARAM_FIELDS, apply_params, init_state,
    )

    jdata, _, pdata, pmeta, _ = shared_inputs(name)
    _, meta, _, _ = jax_accel(name)
    jacc, pacc = _accels(name, engine)
    origin, dirs = _eye(name, res)
    _, _, stable = _radiance_both(name, engine, res)
    w = np.random.default_rng(seed).uniform(0.5, 1.0, (len(dirs), 3))
    w = (w * stable[:, None]).astype(np.float32)

    def jloss(p):
        c = jrender(japply(jdata, p), meta, jnp.asarray(origin),
                    jnp.asarray(dirs), bvh=jacc, engine=engine,
                    differentiable=True)
        return jnp.sum(c * w)

    jg = jax.grad(jloss)(jextract(jdata))
    state = init_state(pdata)
    c = prender(apply_params(pdata, state.params), pmeta,
                torch.from_numpy(origin), torch.from_numpy(dirs), pacc,
                engine=engine, differentiable=True)
    (c * torch.from_numpy(w)).sum().backward()
    pg = {f: state.params[f].grad for f in PARAM_FIELDS}
    return {f: np.asarray(jg[f]) for f in PARAM_FIELDS}, pg, stable


@pytest.mark.parametrize("name,res", [("entry", 24), ("terrain16", 16)])
@pytest.mark.parametrize("engine", ENGINES)
def test_gradients_match_jax(name, res, engine):
    """The gradient of every trainable field through each engine equals
    jax.grad's within 2e-3 of the field's max |g| (and some gradient
    reaches the geometry, the materials and the lights)."""
    jg, pg, stable = _grads_both(name, engine, res)
    assert stable.mean() > 0.99
    for f, want in jg.items():
        got = pg[f]
        assert got is not None and torch.isfinite(got).all(), f
        scale = float(np.abs(want).max())
        err = float(np.abs(got.numpy() - want).max())
        assert err <= 2e-3 * scale, (f, err, scale)
    for f in ("vertices", "mat_diffuse", "light_int", "light_pos"):
        assert float(np.abs(jg[f]).max()) > 0, f


def _fd_check(name, field, index, eps, rtol, atol=1e-4, engine="brute",
              res=24):
    """Central finite difference of sum(radiance * w) over the rays whose
    prim ids are the same at every bounce at x - eps, x and x + eps,
    against the port's autograd gradient (the JAX package's test_grad
    cases)."""
    from raytracer_tpu_torch.models import whitted as PW
    from raytracer_tpu_torch.parallel.train import apply_params, init_state

    _, _, pdata, pmeta, _ = shared_inputs(name)
    _, pacc = _accels(name, engine)
    origin, dirs = _eye(name, res)
    o, d = torch.from_numpy(origin), torch.from_numpy(dirs)
    w = torch.from_numpy(np.random.default_rng(3).uniform(
        0.5, 1.0, (len(dirs), 3)).astype(np.float32))

    def perturbed(h):
        arr = getattr(pdata, field).numpy().astype(np.float64).copy()
        arr[index] += h
        return dataclasses.replace(
            pdata, **{field: torch.from_numpy(arr.astype(np.float32))})

    def render(data):
        return PW.render_rays(data, pmeta, o, d, pacc, engine=engine,
                              differentiable=True)

    prims = []
    porig = PW.refine_hit

    def rec(*a):
        prims[-1].append(a[-1].clone())
        return porig(*a)

    PW.refine_hit = rec
    try:
        with torch.no_grad():
            colors = []
            for h in (-eps, 0.0, eps):
                prims.append([])
                colors.append(render(perturbed(h)))
    finally:
        PW.refine_hit = porig
    stable = torch.ones(len(dirs), dtype=torch.bool)
    for bounce in zip(*prims):
        stable &= (bounce[0] == bounce[1]) & (bounce[1] == bounce[2])
    assert int(stable.sum()) > len(dirs) // 4
    ws = w * stable[:, None]
    fd = float(((colors[2] - colors[0]).double() * ws).sum()) / (2 * eps)
    state = init_state(pdata, fields=(field,))
    (render(apply_params(pdata, state.params)) * ws).sum().backward()
    g = float(state.params[field].grad[index])
    assert np.isfinite(g)
    np.testing.assert_allclose(g, fd, rtol=rtol, atol=atol)


@pytest.mark.parametrize("engine", ENGINES)
def test_grad_diffuse_fd(engine):
    _fd_check("entry", "mat_diffuse", (0, 1), eps=1e-2, rtol=2e-2,
              engine=engine)


def test_grad_light_intensity_fd():
    _fd_check("entry", "light_int", (0, 0), eps=1.0, rtol=2e-2)


def test_grad_light_pos_fd():
    _fd_check("entry", "light_pos", (0, 0), eps=1e-2, rtol=5e-2)


def test_grad_sphere_radius_fd():
    _fd_check("entry", "sphere_rad", (0,), eps=1e-3, rtol=5e-2, atol=2e-2)


@pytest.mark.parametrize("engine", ENGINES)
def test_grad_vertex_fd(engine):
    """The accelerator is built from the unperturbed geometry, as in
    training: visibility carries no gradient and the stable rays keep
    their topology, so both sides differentiate refine_hit.  The floor
    vertex moves off the floor's plane (y), which tilts it."""
    _fd_check("entry", "vertices", (0, 1), eps=1e-3, rtol=5e-2, atol=2e-2,
              engine=engine)


@pytest.mark.parametrize("name", ["entry", "terrain16"])
def test_grads_finite_everywhere(name):
    """No NaN or inf in any field's gradient of sum(radiance^2) over every
    ray (misses, grazing and mirror lanes included): the where-guards of
    refine_hit and the boolean specular gate."""
    from raytracer_tpu_torch.models.whitted import render_rays
    from raytracer_tpu_torch.parallel.train import apply_params, init_state

    _, _, pdata, pmeta, _ = shared_inputs(name)
    origin, dirs = _eye(name, 24)
    state = init_state(pdata)
    c = render_rays(apply_params(pdata, state.params), pmeta,
                    torch.from_numpy(origin), torch.from_numpy(dirs), None,
                    engine="brute", differentiable=True)
    (c ** 2).sum().backward()
    for f, p in state.params.items():
        assert torch.isfinite(p.grad).all(), f"non-finite grad in {f}"


def test_specular_gate_passes_no_gradient():
    """A light straight along the normal (cos_theta = 1 exactly, where
    d arccos / d cos is infinite): the gate is a boolean, so the light
    position's gradient stays finite and equals the JAX package's, which
    stops the gradient at the gate."""
    import jax
    import jax.numpy as jnp

    from raytracer_tpu.ops.shade import Hit as JHit
    from raytracer_tpu.ops.shade import shade_local as jshade
    from raytracer_tpu_torch.ops.shade import Hit, shade_local

    jdata, _, pdata, pmeta, _ = shared_inputs("entry")
    _, meta, _, _ = jax_accel("entry")
    lp = pdata.light_pos[0].numpy()
    point = np.array([[lp[0], -1.0, lp[2]], [lp[0] + 0.5, -1.0, lp[2] - 0.5]],
                     np.float32)
    normal = np.array([[0.0, 1.0, 0.0]] * 2, np.float32)
    dirs = np.array([[0.0, -1.0, -0.5], [0.3, -1.0, -0.5]], np.float32)
    offset = point + normal * np.float32(meta.shadow_eps)
    hit = np.array([True, True])
    mat = np.array([0, 0])

    def jf(light_pos):
        h = JHit(jnp.asarray(hit), jnp.ones(2), jnp.asarray(normal),
                 jnp.asarray(mat, jnp.int32), jnp.asarray(point),
                 jnp.asarray(offset))
        d = dataclasses.replace(jdata, light_pos=light_pos)
        return jnp.sum(jshade(d, meta, jnp.asarray(dirs), h,
                              lambda *a: jnp.zeros(2, bool)))

    jg = np.asarray(jax.grad(jf)(jdata.light_pos))
    lpos = pdata.light_pos.clone().requires_grad_(True)
    h = Hit(torch.from_numpy(hit), torch.ones(2), torch.from_numpy(normal),
            torch.from_numpy(mat), torch.from_numpy(point),
            torch.from_numpy(offset))
    shade_local(dataclasses.replace(pdata, light_pos=lpos), pmeta,
                torch.from_numpy(dirs), h,
                occluded_fn=lambda *a: torch.zeros(2, dtype=torch.bool)
                ).sum().backward()
    assert torch.isfinite(lpos.grad).all()
    np.testing.assert_allclose(lpos.grad.numpy(), jg, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("engine", ["brute", "cluster"])
def test_inverse_rendering_recovers_diffuse(engine):
    """Adam (make_train_step) on the image loss recovers a perturbed
    diffuse albedo through the brute and the cluster engine."""
    from raytracer_tpu_torch.models.whitted import render_rays
    from raytracer_tpu_torch.parallel.train import init_state, make_train_step

    _, _, pdata, pmeta, _ = shared_inputs("entry")
    _, pacc = _accels("entry", engine)
    origin, dirs = map(torch.from_numpy, _eye("entry", 16))
    with torch.no_grad():
        target = render_rays(pdata, pmeta, origin, dirs, pacc, engine=engine)
    bad = dataclasses.replace(pdata, mat_diffuse=pdata.mat_diffuse * 0.3 + 0.05)
    state = init_state(bad, fields=("mat_diffuse",))
    step = make_train_step(pmeta, lr=3e-2, engine=engine, device="cpu")
    losses = []
    for _ in range(60):
        state, loss = step(state, bad, origin, dirs, target, accel=pacc)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.05, losses[::10]
