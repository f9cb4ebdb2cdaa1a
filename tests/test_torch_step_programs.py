"""The port's training step and adaptive frame as compiled programs on the
CPU (``parallel.train._TrainProgram``, ``ops.adaptive._Adaptive``;
``models.programs``), their graphs stand-ins that replay the bodies
(``StubGraph``): the replayed step against the eager step
(``programs.eager()``) bit for bit (loss, gradients, parameters over 3
steps; the entry scene and a 32x32 terrain; new ray and target tensors
every step; with and without vertices trained; a 2-shard one-process
mesh), the program route against the JAX package's step (optax) and
``jax.grad`` at the bars of test_torch_train.py and test_torch_grad.py,
the route rules, the returned loss, a host read inside the step; the
adaptive program against the eager frame bit for bit (image and stats,
1 and 3 rounds, the 24x20 frame whose tiles take ``inv``, the JAX
package's draws injected) and against the JAX package at the bars of
test_torch_adaptive.py.  On the card the same programs are CUDA graphs
(tests/test_torch_gpu.py, chip_smoke.py phase 9)."""

import contextlib
import dataclasses
import functools

import numpy as np
import pytest
import torch

from torch_port_util import (  # noqa: F401 (stub_graphs: a fixture)
    StubGraph, jax_adaptive_jitter, port_scene, shared_inputs, stub_graphs,
)

import test_torch_adaptive
import test_torch_train


@functools.lru_cache(maxsize=None)
def _problem(name: str, res: int):
    """(true data, meta, clusters, origin (3,), dirs, target) of the port's
    scene ``name`` through a res x res camera: eye rays in raster order,
    the target the true scene's radiance."""
    from raytracer_tpu_torch.models.bvh import build_bvh
    from raytracer_tpu_torch.models.clusters import build_clusters
    from raytracer_tpu_torch.models.whitted import eager, render_rays
    from raytracer_tpu_torch.ops.camera import camera_vectors, eye_rays_from

    data, meta = port_scene(name)
    cset = build_clusters(data, meta, build_bvh(data, meta))
    cam = dataclasses.replace(meta.cameras[0], width=res, height=res)
    origin, dirs = eye_rays_from(torch.from_numpy(camera_vectors(cam)),
                                 cam.width, cam.height)
    with torch.no_grad(), eager():
        target = render_rays(data, meta, origin, dirs, cset, engine="cluster")
    return data, meta, cset, origin, dirs, target


def _bad(data):
    return dataclasses.replace(data, mat_diffuse=data.mat_diffuse * 0.5,
                               light_int=data.light_int * 0.7)


FIELDS = ("mat_diffuse", "light_int", "light_pos")


def _steps(name, res, fields, batch, mesh, n=3, engine="cluster"):
    """n steps of make_train_step (lr 1e-2) from the perturbed scene:
    [(loss, {field: grad}, {field: param})] after each step, copies.
    ``batch``: every step a new subset of half the rays (new tensors),
    drawn from one seed."""
    from raytracer_tpu_torch.parallel.mesh import make_mesh
    from raytracer_tpu_torch.parallel.train import init_state, make_train_step

    data, meta, cset, origin, dirs, target = _problem(name, res)
    bad = _bad(data)
    state = init_state(bad, fields=fields)
    step = make_train_step(
        meta, lr=1e-2, engine=engine, ldr=True, device="cpu",
        mesh=make_mesh(devices=["cpu", "cpu"]) if mesh else None)
    rng = np.random.default_rng(7)
    out = []
    for _ in range(n):
        d, t = dirs, target
        if batch:
            idx = torch.from_numpy(rng.choice(len(dirs), len(dirs) // 2,
                                              replace=False))
            d, t = dirs[idx], target[idx]
        state, loss = step(state, bad, origin, d, t, accel=cset)
        out.append((loss.clone(),
                    {f: p.grad.clone() for f, p in state.params.items()},
                    {f: p.detach().clone() for f, p in state.params.items()}))
    return out


def _assert_steps_equal(got, want):
    for i, ((gl, gg, gp), (wl, wg, wp)) in enumerate(zip(got, want)):
        assert torch.equal(gl, wl), f"step {i + 1}: loss {gl} vs {wl}"
        for f in wg:
            assert torch.equal(gg[f], wg[f]), f"step {i + 1}: {f} gradient"
            assert torch.equal(gp[f], wp[f]), f"step {i + 1}: {f} param"


@pytest.mark.parametrize("name,res,fields,batch,mesh", [
    ("entry", 24, FIELDS, False, False),
    ("entry", 24, FIELDS + ("vertices",), True, False),
    ("terrain16", 32, FIELDS, True, False),
    ("terrain16", 32, FIELDS + ("vertices",), False, False),
    ("terrain16", 32, FIELDS + ("vertices",), True, True),
    ("entry", 24, FIELDS, False, True),
])
def test_train_step_replays_equal_eager(stub_graphs, name, res, fields, batch,
                                        mesh):
    """The step through its program (an eager first run, the capture,
    then replays) equals the eager step bit for bit after each of 3
    steps: one capture, and none under eager()."""
    c0 = stub_graphs.stats["captures"]
    got = _steps(name, res, fields, batch, mesh)
    assert stub_graphs.stats["captures"] == c0 + 1
    with stub_graphs.eager():
        want = _steps(name, res, fields, batch, mesh)
    assert stub_graphs.stats["captures"] == c0 + 1
    _assert_steps_equal(got, want)
    assert all(bool(torch.isfinite(loss)) for loss, _, _ in got)


def test_program_route_meets_jax_bars(stub_graphs):
    """The program route on the cluster engine against the JAX package's
    step (optax adam, the cluster engine, the same clusters): step 1's
    gradients within 2e-3 of each field's max |g| of jax.grad's
    (test_torch_grad.py's bar), then losses, params and moments after 3
    steps at test_torch_train.py's bars."""
    import jax
    import jax.numpy as jnp
    import optax

    from raytracer_tpu.parallel.mesh import make_mesh
    from raytracer_tpu.parallel.train import image_loss as jloss
    from raytracer_tpu.parallel.train import init_state as jinit
    from raytracer_tpu.parallel.train import make_train_step as jmake
    from raytracer_tpu_torch.parallel.train import init_state, make_train_step

    fields = test_torch_train.FIELDS
    jdata, pdata, meta, pmeta, origin, dirs, target = test_torch_train._setup()
    _, jcs, _, _, pcs = shared_inputs("entry")
    jstate = jinit(jdata, optax.adam(1e-2), fields=fields)
    args = (jnp.asarray(origin), jnp.asarray(dirs), jnp.asarray(target))
    jgrad = jax.grad(jloss)(jstate.params, jdata, meta, *args, jcs,
                            "cluster", True)
    jstep = jmake(meta, make_mesh(n=1), optax.adam(1e-2), engine="cluster",
                  has_bvh=True, ldr=True)
    state = init_state(pdata, fields=fields)
    step = make_train_step(pmeta, lr=1e-2, engine="cluster", ldr=True,
                           device="cpu")
    c0 = stub_graphs.stats["captures"]
    jl, pl = [], []
    for i in range(3):
        jstate, loss = jstep(jstate, jdata, *args, jcs)
        jl.append(float(loss))
        state, loss = step(state, pdata, *(torch.from_numpy(x) for x in
                                           (origin, dirs, target)), accel=pcs)
        pl.append(float(loss))
        if i == 0:
            for f in fields:
                want = np.asarray(jgrad[f])
                err = float(np.abs(state.params[f].grad.numpy() - want).max())
                assert err <= 2e-3 * float(np.abs(want).max()), f
    assert stub_graphs.stats["captures"] == c0 + 1
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    test_torch_train._assert_states_close(
        state, test_torch_train._jax_numpy(jstate), 1e-4, "after 3 steps")


def test_route_rules(stub_graphs):
    """brute and bvh keep a program too, captured on the first step and
    replayed on the second; the cluster engine captures once per
    state, a new state captures anew, and of three states the least
    recently used one's program is dropped (MAX_TRAIN_PROGRAMS = 2);
    eager() and debug_nans() capture nothing."""
    from raytracer_tpu_torch.models.bvh import build_bvh, device_bvh
    from raytracer_tpu_torch.models.whitted import debug_nans
    from raytracer_tpu_torch.parallel.train import (
        MAX_TRAIN_PROGRAMS, init_state, make_train_step,
    )

    data, meta, cset, origin, dirs, target = _problem("entry", 16)
    bad = _bad(data)
    captures = lambda: stub_graphs.stats["captures"]  # noqa: E731
    for engine, accel in (("brute", None),
                          ("bvh", device_bvh(build_bvh(data, meta,
                                                       ordered=True), "cpu"))):
        step = make_train_step(meta, engine=engine, device="cpu")
        state = init_state(bad, fields=FIELDS)
        c0 = captures()
        step(state, bad, origin, dirs, target, accel=accel)
        c1 = captures()
        step(state, bad, origin, dirs, target, accel=accel)
        assert c1 > c0 and captures() == c1, engine
        assert len(step.programs) == 1, engine
    assert MAX_TRAIN_PROGRAMS == 2
    step = make_train_step(meta, engine="cluster", device="cpu")
    states = [init_state(bad, fields=FIELDS) for _ in range(3)]
    c0 = captures()
    for i in (0, 0, 1, 1, 2, 2):
        step(states[i], bad, origin, dirs, target, accel=cset)
    assert captures() == c0 + 3
    step(states[2], bad, origin, dirs, target, accel=cset)
    step(states[1], bad, origin, dirs, target, accel=cset)
    assert captures() == c0 + 3
    step(states[0], bad, origin, dirs, target, accel=cset)
    assert captures() == c0 + 4
    step(states[0], bad, origin, dirs[:128], target[:128], accel=cset)
    assert captures() == c0 + 5          # another shape: another program
    with stub_graphs.eager():
        step(states[0], bad, origin, dirs, target, accel=cset)
    with debug_nans():
        step(states[0], bad, origin, dirs, target, accel=cset)
    assert captures() == c0 + 5


def test_returned_loss_survives_next_step(stub_graphs):
    """The step returns a copy of its static loss: a later replay leaves a
    loss the caller kept as it was."""
    from raytracer_tpu_torch.parallel.train import init_state, make_train_step

    data, meta, cset, origin, dirs, target = _problem("entry", 16)
    bad = _bad(data)
    step = make_train_step(meta, lr=1e-1, engine="cluster", device="cpu")
    state = init_state(bad, fields=FIELDS)
    losses = [step(state, bad, origin, dirs, target, accel=cset)[1]
              for _ in range(4)]
    kept = [x.clone() for x in losses]
    step(state, bad, origin, dirs, target, accel=cset)
    assert all(torch.equal(a, b) for a, b in zip(losses, kept))
    assert len({float(x) for x in losses}) == 4


class _HostReadRefusing(StubGraph):
    """A stub graph whose capture, as a CUDA graph's, refuses a host read
    of a tensor (``Tensor.item``)."""

    def capture(self, body):
        from torch.overrides import TorchFunctionMode

        class Refuse(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                if func is torch.Tensor.item:
                    raise RuntimeError("operation not permitted when stream "
                                       "is capturing")
                return func(*args, **(kwargs or {}))

        with Refuse():
            body()
        super().capture(body)


def test_host_read_in_step_raises(monkeypatch):
    """A host read put into the step's body: the first run (eager) passes,
    its capture raises, naming the step; nothing falls back to eager."""
    from raytracer_tpu_torch.models import programs
    from raytracer_tpu_torch.parallel import train
    from raytracer_tpu_torch.parallel.train import init_state, make_train_step

    monkeypatch.setattr(programs, "graph_class", lambda device: (
        None if programs._eager[0] else _HostReadRefusing))
    loss_fn = train.image_loss

    def reading(*a, **kw):
        loss = loss_fn(*a, **kw)
        loss.item()
        return loss
    monkeypatch.setattr(train, "image_loss", reading)
    data, meta, cset, origin, dirs, target = _problem("entry", 16)
    bad = _bad(data)
    step = make_train_step(meta, engine="cluster", device="cpu")
    state = init_state(bad, fields=FIELDS)
    with pytest.raises(RuntimeError, match="capture of the step 'train step' "
                       "failed: RuntimeError: operation not permitted"):
        step(state, bad, origin, dirs, target, accel=cset)
    with programs.eager():
        step(state, bad, origin, dirs, target, accel=cset)


@pytest.mark.parametrize("rounds", [1, 3])
@pytest.mark.parametrize("size", [(24, 20), None])
def test_adaptive_replays_equal_eager(stub_graphs, rounds, size):
    """The adaptive frame through its program (first run eager, captured,
    then replayed) equals the eager frame bit for bit, image and stats:
    the 24x20 frame (padded tiles, the ``inv`` gather) and the entry
    camera, at 1 and 3 rounds, with the JAX package's draws injected."""
    from raytracer_tpu_torch.ops.adaptive import render_camera_adaptive

    _, _, pdata, pmeta, pcs = shared_inputs("entry")
    cam = pmeta.cameras[0]
    if size is not None:
        cam = dataclasses.replace(cam, width=size[0], height=size[1])
    kw = dict(base_spp=3, extra_spp=7, refine_frac=0.5, rounds=rounds,
              seed=5, jitter=jax_adaptive_jitter(5), device="cpu")
    c0 = stub_graphs.stats["captures"]
    got = [render_camera_adaptive(pdata, pmeta, cam, pcs, **kw)
           for _ in range(2)]
    assert stub_graphs.stats["captures"] > c0
    c1 = stub_graphs.stats["captures"]
    with stub_graphs.eager():
        want, wstats = render_camera_adaptive(pdata, pmeta, cam, pcs, **kw)
    assert stub_graphs.stats["captures"] == c1
    for img, stats in got:
        assert torch.equal(img, want) and stats == wstats
        assert img.shape == (cam.height, cam.width, 3)
    assert stats["rounds"] == rounds and bool(torch.isfinite(want).all())


@pytest.mark.parametrize("case", [test_torch_adaptive.CASES[i]
                                  for i in (2, 3, 4)])
def test_adaptive_program_meets_jax_bars(stub_graphs, case, monkeypatch):
    """test_torch_adaptive's bars against the JAX package, through the
    program: its first render captures, its second replays."""
    c0 = stub_graphs.stats["captures"]
    test_torch_adaptive.test_adaptive_matches_jax(*case, monkeypatch)
    c1 = stub_graphs.stats["captures"]
    assert c1 > c0
    test_torch_adaptive.test_adaptive_matches_jax(*case, monkeypatch)
    assert stub_graphs.stats["captures"] == c1


def test_dropped_gradients_are_handed_back(stub_graphs):
    """A caller that sets the gradients to None between replays (the
    default zero_grad) gets the program's buffers back at the next step,
    equal to the eager step's gradients."""
    from raytracer_tpu_torch.parallel.train import init_state, make_train_step

    data, meta, cset, origin, dirs, target = _problem("entry", 16)
    bad = _bad(data)
    got = []
    for graphs in (True, False):
        step = make_train_step(meta, lr=1e-2, engine="cluster", device="cpu")
        state = init_state(bad, fields=FIELDS)
        with contextlib.nullcontext() if graphs else stub_graphs.eager():
            for _ in range(3):
                state.opt.zero_grad()
                step(state, bad, origin, dirs, target, accel=cset)
        got.append({f: p.grad.clone() for f, p in state.params.items()})
        if graphs:
            (prog,) = step.programs.values()
            assert all(p.grad is g for p, g in zip(state.params.values(),
                                                   prog.grads))
    for f in FIELDS:
        assert torch.equal(got[0][f], got[1][f]), f
