"""The brute and BVH engines as compiled programs on the CPU
(``models.whitted._Wavefront`` on every engine, the BVH bounce cut at its
two walks, ``ops.traverse.Walk``; the two-pass BVH training step of
``parallel.train._TrainProgram``; ``models.programs``), their graphs
stand-ins that replay the bodies (``StubGraph``), on the entry scene and
a cells=16 terrain through 32x32 cameras: (a) the fixed-shape engines
(every lane traced, the inactive ones filled) against the subset engines,
which traced the active lanes only (frozen in torch_port_util), bit for
bit with the same walk iterations, on their own and through whole
renders; (b) ``render_rays``, ``render_camera``, streamed bands (parity,
chunked, jitter), the adaptive frame and a 2-shard mesh band replayed
against ``programs.eager()`` bit for bit, captured once; (c) 3 training
steps through the program against 3 eager steps and against the subset
engines' one-pass eager step bit for bit (loss, gradients, parameters), and the
BVH step against ``jax.grad`` and the JAX package's step at the bars of
test_torch_grad.py and test_torch_train.py; (d) two processes over gloo
on the BVH engine; (e) the server's LRU dropping a BVH scene's programs.
On the card the same programs are CUDA graphs (tests/test_torch_gpu.py,
chip_smoke.py phase 10)."""

import dataclasses
import functools
import shutil

import numpy as np
import pytest
import torch

import torch_port_util as U
from torch_port_util import (  # noqa: F401 (stub_graphs: a fixture)
    ENTRY_XML, assert_same, jax_accel, port_scene, scene_rays, shared_inputs,
    stub_graphs,
)

import test_torch_mesh_programs
import test_torch_train

ENGINES = ["brute", "bvh"]
SCENES = ["entry", "terrain16"]
RES = 32


@functools.lru_cache(maxsize=None)
def _scene(name):
    """(data, meta, camera, {engine: accel}) of the port's scene ``name``
    (its own builds; the BVH with its octant threads, as
    ``render.engine_accel`` builds it), the camera cut to 32x32."""
    from raytracer_tpu_torch.models.bvh import build_bvh, device_bvh

    data, meta = port_scene(name)
    cam = dataclasses.replace(meta.cameras[0], width=RES, height=RES)
    bvh = device_bvh(build_bvh(data, meta, ordered=True), "cpu")
    return data, meta, cam, {"brute": None, "bvh": bvh}


def _eye(name):
    """(origin (3,), dirs (R, 3)) of the 32x32 camera, raster order."""
    from raytracer_tpu_torch.ops.camera import camera_vectors, eye_rays_from

    _, _, cam, _ = _scene(name)
    return eye_rays_from(torch.from_numpy(camera_vectors(cam)), cam.width,
                         cam.height)


def _iterations():
    from raytracer_tpu_torch.ops.traverse import walk_stats

    return walk_stats["iterations"]


# (a) the fixed-shape engines against the subset engines
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", ["entry", "terrain16", "spheres600"])
def test_engines_equal_subset_engines_on_active_lanes(name, engine):
    """closest_hit and any_hit on random rays (90% active, and all): equal
    to the subset engines on every lane (the inactive ones MISS / False
    in both), each BVH walk with the same iterations."""
    from raytracer_tpu_torch.models.bvh import build_bvh, device_bvh
    from raytracer_tpu_torch.ops import traverse as PT

    _, _, pdata, pmeta, _ = shared_inputs(name)
    cs = jax_accel(name)[3]
    accel = (device_bvh(build_bvh(pdata, pmeta, ordered=True), "cpu")
             if engine == "bvh" else None)
    origin, dirs, active = scene_rays(cs, 2048, 11)
    t_max = np.random.default_rng(3).uniform(0.2, 1.0, len(dirs))
    o, d, a, tm = (torch.from_numpy(x) for x in (
        origin, dirs, active, t_max.astype(np.float32)))
    for act in (a, None):
        for what, new, old in (
                ("closest", lambda: PT.closest_hit(pdata, o, d, accel, engine,
                                                   active=act),
                 lambda: U.subset_closest_hit(pdata, o, d, accel, engine,
                                            active=act)),
                ("any", lambda: PT.any_hit(pdata, o, d, tm, accel, engine,
                                           active=act),
                 lambda: U.subset_any_hit(pdata, o, d, tm, accel, engine,
                                        active=act))):
            U.subset_walk_iterations.clear()
            it0 = _iterations()
            got, want = new(), old()
            assert_same(got, want, f"{name} {engine} {what}")
            assert _iterations() - it0 == sum(U.subset_walk_iterations)
            if engine == "bvh":
                assert U.subset_walk_iterations[0] > 0
    if engine == "bvh":
        # an empty active set walks no iteration, as the subset walk did
        it0 = _iterations()
        none = torch.zeros_like(a)
        assert (PT.closest_hit(pdata, o, d, accel, engine, active=none)
                == PT.MISS).all()
        assert _iterations() == it0


@pytest.mark.parametrize("differentiable", [False, True])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", SCENES)
def test_render_rays_equals_subset_engines(name, engine, differentiable):
    """render_rays through the wavefront (and, differentiable on the BVH
    engine, the recording pass and the recorded bounces) against the
    one-pass loop on the subset engines: the same radiance bit for bit,
    the same walk iterations (the recording pass walks as that loop did)."""
    from raytracer_tpu_torch.models.whitted import render_rays

    data, meta, _, accels = _scene(name)
    origin, dirs = _eye(name)
    U.subset_walk_iterations.clear()
    with torch.no_grad():
        want = U.subset_render_rays(data, meta, origin, dirs, accels[engine],
                                  engine, differentiable=differentiable)
    it0 = _iterations()
    with torch.no_grad():
        got = render_rays(data, meta, origin, dirs, accels[engine],
                          engine=engine, differentiable=differentiable)
    assert torch.equal(got, want)
    assert _iterations() - it0 == sum(U.subset_walk_iterations)
    if engine == "bvh":
        assert sum(U.subset_walk_iterations) > 0


# (b) renders replayed against eager()
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", SCENES)
def test_render_rays_replays_equal_eager(stub_graphs, name, engine, shared):
    """render_rays of two ray sets (shared and per-ray origins): the first
    call captures the wavefront's steps, every later call replays them,
    each equal to its eager render bit for bit."""
    from raytracer_tpu_torch.models.whitted import eager, render_rays

    data, meta, _, accels = _scene(name)
    origin, dirs = _eye(name)
    if not shared:
        origin = origin.expand(dirs.shape).contiguous()
    rng = np.random.default_rng(0)
    c0 = stub_graphs.stats["captures"]
    for k in range(3):
        d = dirs + torch.from_numpy(
            rng.normal(0, 0.01 * k, dirs.shape).astype(np.float32))
        with eager():
            want = render_rays(data, meta, origin, d, accels[engine],
                               engine=engine)
        got = render_rays(data, meta, origin, d, accels[engine],
                          engine=engine)
        assert torch.equal(got, want), k
        if k == 0:
            c1 = stub_graphs.stats["captures"]
            assert c1 > c0
    assert stub_graphs.stats["captures"] == c1
    progs = stub_graphs.scene_programs(data, meta, accels[engine], "cpu")
    assert [k[:2] for k in progs] == [("rays", engine)]


FRAMES = {
    "camera": None,
    "parity": dict(ssaa=2),
    # 16-row bands of 64 rays cut into 640-ray chunks, the last padded
    "chunked": dict(ssaa=2, chunk=700),
    "jitter": dict(ssaa=2, ssaa_mode="jitter", seed=3),
    "adaptive": dict(ssaa=2, ssaa_mode="adaptive", seed=4),
    "mesh": dict(ssaa=2, mesh=2),
}


@pytest.mark.parametrize("frame", list(FRAMES))
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", SCENES)
def test_frames_replay_equal_eager(stub_graphs, name, engine, frame):
    """render_camera's radiance and render_one_camera's streamed (parity,
    chunked, jitter), adaptive and 2-shard mesh frames: the first frame
    captures, the second replays only, both equal to the eager frame bit
    for bit."""
    from raytracer_tpu_torch.models.whitted import eager, render_camera
    from raytracer_tpu_torch.parallel.mesh import make_mesh
    from raytracer_tpu_torch.pipeline import render_one_camera

    data, meta, cam, accels = _scene(name)
    accel = accels[engine]
    kw = dict(FRAMES[frame] or {})
    if kw.pop("mesh", None):
        kw["mesh"] = make_mesh(devices=["cpu", "cpu"])

    def render():
        if FRAMES[frame] is None:
            return render_camera(data, meta, cam, accel, device="cpu",
                                 engine=engine)
        return torch.from_numpy(render_one_camera(
            data, meta, cam, accel, device="cpu", engine=engine, **kw)[0])

    with eager():
        want = render()
    assert not stub_graphs._scenes
    c0 = stub_graphs.stats["captures"]
    got = render()
    c1 = stub_graphs.stats["captures"]
    again = render()
    assert c1 > c0 and stub_graphs.stats["captures"] == c1
    assert got.shape[:2] == (cam.height, cam.width)
    assert torch.equal(got, want) and torch.equal(again, want)
    progs = stub_graphs.scene_programs(data, meta, accel, "cpu")
    kinds = {k[0] for k in progs}
    assert kinds == ({"adaptive", "rays"} if frame == "adaptive"
                     else {"frame", "rays"})
    assert all(k[1] == engine for k in progs if k[0] == "rays")


def test_bvh_bounce_steps_and_walk_blocks(stub_graphs):
    """The BVH wavefront's steps: per bounce the closest walk's set-up, the
    shadow set-up and the shading, and one block step per walk, shared by
    every bounce; a replayed frame reads the walks' flags once a block
    plus once per walk, and the bounce flags between bounces."""
    from raytracer_tpu_torch.models.whitted import render_rays
    from raytracer_tpu_torch.ops.traverse import walk_stats

    data, meta, _, accels = _scene("terrain16")
    origin, dirs = _eye("terrain16")
    render_rays(data, meta, origin, dirs, accels["bvh"], engine="bvh")
    (wf,) = stub_graphs.scene_programs(data, meta, accels["bvh"],
                                       "cpu").values()
    names = sorted(s.name for steps in wf.steps.values() for s in steps
                   if hasattr(s, "name"))
    depths = range(meta.max_depth + 1)
    assert names == sorted(
        [f"bounce {d} {p}" for d in depths
         for p in ("closest set-up", "shadow set-up", "shading")])
    assert sorted(s.name for s in wf.blocks.values()) == [
        "closest walk block", "shadow walk block"]
    assert all(s.graph is not None for s in wf.blocks.values())
    r0, b0 = stub_graphs.stats["flag_reads"], walk_stats["blocks"]
    render_rays(data, meta, origin, dirs, accels["bvh"], engine="bvh")
    reads = stub_graphs.stats["flag_reads"] - r0
    blocks = walk_stats["blocks"] - b0
    bounces = len(wf.steps)
    # a read after every block and the one that ends each walk; one
    # between bounces, the last of them ending the loop when it did
    assert blocks > 2 * bounces
    assert reads == blocks + 2 * bounces + min(bounces, meta.max_depth)


# (c) the training step
FIELDS = ("mat_diffuse", "light_int", "light_pos", "vertices")


@functools.lru_cache(maxsize=None)
def _problem(name, engine):
    """(true data, meta, accel, origin, dirs, target) through the 32x32
    camera: the target the true scene's radiance on ``engine``."""
    from raytracer_tpu_torch.models.whitted import eager, render_rays

    data, meta, _, accels = _scene(name)
    origin, dirs = _eye(name)
    with torch.no_grad(), eager():
        target = render_rays(data, meta, origin, dirs, accels[engine],
                             engine=engine)
    return data, meta, accels[engine], origin, dirs, target


def _steps(name, engine, mesh=False, n=3):
    """n steps of make_train_step (lr 1e-2, ldr) from the perturbed scene,
    every step a new subset of half the rays: [(loss, {field: grad},
    {field: param})] after each step, copies."""
    from raytracer_tpu_torch.parallel.mesh import make_mesh
    from raytracer_tpu_torch.parallel.train import init_state, make_train_step

    data, meta, accel, origin, dirs, target = _problem(name, engine)
    bad = dataclasses.replace(data, mat_diffuse=data.mat_diffuse * 0.5,
                              light_int=data.light_int * 0.7)
    state = init_state(bad, fields=FIELDS)
    step = make_train_step(
        meta, lr=1e-2, engine=engine, ldr=True, device="cpu",
        mesh=make_mesh(devices=["cpu", "cpu"]) if mesh else None)
    rng = np.random.default_rng(7)
    out = []
    for _ in range(n):
        idx = torch.from_numpy(rng.choice(len(dirs), len(dirs) // 2,
                                          replace=False))
        state, loss = step(state, bad, origin, dirs[idx], target[idx],
                           accel=accel)
        out.append((loss.clone(),
                    {f: p.grad.clone() for f, p in state.params.items()},
                    {f: p.detach().clone() for f, p in state.params.items()}))
    return out


def _assert_steps_equal(got, want, what):
    for i, ((gl, gg, gp), (wl, wg, wp)) in enumerate(zip(got, want)):
        assert torch.equal(gl, wl), f"{what} step {i + 1}: loss {gl} vs {wl}"
        for f in wg:
            assert torch.equal(gg[f], wg[f]), f"{what} step {i + 1}: {f} grad"
            assert torch.equal(gp[f], wp[f]), f"{what} step {i + 1}: {f} param"


def _subset_one_pass(data, meta, origin, dirs, accel, engine="cluster",
                      differentiable=False, visibility=None, **kw):
    assert visibility is None
    return U.subset_render_rays(data, meta, origin, dirs, accel, engine,
                              differentiable=differentiable)


@pytest.mark.parametrize("name,engine,mesh", [
    ("entry", "brute", False), ("terrain16", "brute", False),
    ("entry", "bvh", False), ("terrain16", "bvh", False),
    ("entry", "bvh", True)])
def test_train_step_replays_equal_eager_and_one_pass(stub_graphs, monkeypatch,
                                                 name, engine, mesh):
    """3 steps through the program (brute: one graph; bvh: the visibility
    pass's steps, then one graph; on a 2-shard mesh a visibility pass per
    shard) against 3 eager steps and against the one-pass eager step on
    the subset engines, bit for bit: one capture of the graph."""
    from raytracer_tpu_torch.models.whitted import eager
    from raytracer_tpu_torch.parallel import train

    c0 = stub_graphs.stats["captures"]
    got = _steps(name, engine, mesh)
    captured = stub_graphs.stats["captures"] - c0
    if engine == "brute":
        assert captured == 1
    else:
        assert captured > 1            # the visibility steps and the graph
    with eager():
        want = _steps(name, engine, mesh)
        monkeypatch.setattr(train, "render_rays", _subset_one_pass)
        one_pass = _steps(name, engine, mesh)
    assert stub_graphs.stats["captures"] == c0 + captured
    _assert_steps_equal(got, want, "program vs eager")
    _assert_steps_equal(got, one_pass, "program vs one pass")
    assert all(bool(torch.isfinite(loss)) for loss, _, _ in got)


def test_bvh_program_route_meets_jax_bars(stub_graphs):
    """The BVH step through its program against the JAX package's step on
    its BVH (optax adam): step 1's gradients within 2e-3 of each field's
    max |g| of jax.grad's (test_torch_grad.py's bar), then losses, params
    and moments after 3 steps at test_torch_train.py's bars."""
    import jax
    import jax.numpy as jnp
    import optax

    from raytracer_tpu.parallel.mesh import make_mesh
    from raytracer_tpu.parallel.train import image_loss as jloss
    from raytracer_tpu.parallel.train import init_state as jinit
    from raytracer_tpu.parallel.train import make_train_step as jmake
    from raytracer_tpu_torch.models.bvh import build_bvh, device_bvh
    from raytracer_tpu_torch.parallel.train import init_state, make_train_step

    fields = test_torch_train.FIELDS
    jdata, pdata, meta, pmeta, origin, dirs, target = test_torch_train._setup()
    jbvh = jax.device_put(jax_accel("entry")[2])
    pbvh = device_bvh(build_bvh(pdata, pmeta, ordered=True), "cpu")
    jstate = jinit(jdata, optax.adam(1e-2), fields=fields)
    args = (jnp.asarray(origin), jnp.asarray(dirs), jnp.asarray(target))
    jgrad = jax.grad(jloss)(jstate.params, jdata, meta, *args, jbvh, "bvh",
                            True)
    jstep = jmake(meta, make_mesh(n=1), optax.adam(1e-2), engine="bvh",
                  has_bvh=True, ldr=True)
    state = init_state(pdata, fields=fields)
    step = make_train_step(pmeta, lr=1e-2, engine="bvh", ldr=True,
                           device="cpu")
    c0 = stub_graphs.stats["captures"]
    jl, pl = [], []
    for i in range(3):
        jstate, loss = jstep(jstate, jdata, *args, jbvh)
        jl.append(float(loss))
        state, loss = step(state, pdata, *(torch.from_numpy(x) for x in
                                           (origin, dirs, target)),
                           accel=pbvh)
        pl.append(float(loss))
        if i == 0:
            c1 = stub_graphs.stats["captures"]
            assert c1 > c0
            for f in fields:
                want = np.asarray(jgrad[f])
                err = float(np.abs(state.params[f].grad.numpy() - want).max())
                assert err <= 2e-3 * float(np.abs(want).max()), f
    assert stub_graphs.stats["captures"] == c1
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    test_torch_train._assert_states_close(
        state, test_torch_train._jax_numpy(jstate), 1e-4, "after 3 steps")


# (d) two processes over gloo on the BVH engine
def test_two_processes_replay_bvh(tmp_path):
    """test_torch_mesh_programs' two-rank worker on the BVH engine: its
    frames replayed equal to eager and to one device, the sharded
    wavefront, and the two-step train program (after each shard's
    visibility pass) equal to the eager multi-process step over 3 steps,
    the ranks' parameters equal."""
    test_torch_mesh_programs.run_two_ranks(tmp_path, "cpu", engine="bvh")


# (e) the server's LRU
def test_server_lru_drops_bvh_programs(stub_graphs, tmp_path):
    """A served --engine bvh request keeps the scene's programs (a second
    request captures nothing and renders the same image); evicting the
    scene drops them."""
    from raytracer_tpu_torch.serve import RenderServer
    from raytracer_tpu_torch.utils.ppm import read_ppm

    other = tmp_path / "other.xml"
    shutil.copy(ENTRY_XML, other)
    server = RenderServer(max_scenes=1, mesh="1", device="cpu")
    imgs = []
    for i in range(2):
        r = server.handle({"scene": ENTRY_XML, "engine": "bvh",
                           "out_dir": str(tmp_path / f"a{i}")})
        assert r["ok"], r
        imgs.append(read_ppm(r["images"][0]))
        if i == 0:
            c1 = stub_graphs.stats["captures"]
    assert stub_graphs.stats["captures"] == c1 and (imgs[0] == imgs[1]).all()
    (data, _, bvh), = server._scenes.values()
    assert type(bvh).__name__ == "DeviceBVH"
    assert stub_graphs.cached(data) > 0
    r = server.handle({"scene": str(other), "engine": "bvh",
                       "out_dir": str(tmp_path / "b")})
    assert r["ok"], r
    (data2, _, _), = server._scenes.values()
    assert stub_graphs.cached(data) == 0 and stub_graphs.cached(data2) > 0
    assert all(p.refs[0] is not data for p in stub_graphs._scenes.values())
