"""The port's mesh renders and multi-process training step as compiled
programs on the CPU (``models.whitted._MeshFrame``, the sharded
wavefront of ``parallel.render.render_rays_sharded``, the two-step
``parallel.train._TrainProgram``; ``models.programs``), their graphs
stand-ins that replay the bodies (``StubGraph``): (a) the replayed mesh
band against the eager mesh band (``programs.eager()``) and the
one-device render bit for bit, on 2 and 8 logical shards, in parity and
jitter at --ssaa 2, on a 150-row frame whose last band takes virtual
rows and with shards cut into chunks; (b) the sharded wavefront replayed
against eager; (c) the captures: none for a second frame, anew after an
in-place scene edit, and the per-device replicas (``replicate``) kept,
remade after an edit and forgotten by ``programs.drop`` (also when the
server evicts a scene); (d) two processes over gloo, whose frames replay
equal to eager and to one device and whose two-step train program equals
the eager multi-process step bit for bit over 3 steps, its buffers put;
(e) the program route against the JAX package's 8-device mesh at the
bars of test_torch_parallel.py.  On the card the same programs are CUDA
graphs (tests/test_torch_gpu.py, chip_smoke.py phases 8a, 8b, 8e)."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from torch_port_util import (  # noqa: F401 (stub_graphs: a fixture)
    ENTRY_XML, port_scene, shared_inputs, stub_graphs,
)

import test_torch_parallel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mesh(n):
    from raytracer_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(devices=["cpu"] * n)


def _render(data, meta, cam, accel, mesh=None, **kw):
    from raytracer_tpu_torch.pipeline import render_one_camera

    return torch.from_numpy(render_one_camera(data, meta, cam, accel,
                                              device="cpu", mesh=mesh,
                                              **kw)[0])


# (scene, camera (w, h) or None for the scene's, render_one_camera's kw)
BANDS = {
    "parity": ("entry", None, dict(ssaa=2)),
    "jitter": ("terrain16", None, dict(ssaa=2, ssaa_mode="jitter", seed=3)),
    "padded": ("terrain16", (128, 150), {}),
    # 2,048- and 8,192-ray bands: each shard's rays cut into 512-ray chunks
    "chunked": ("terrain16", (128, 40), dict(chunk=600)),
}


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("case", list(BANDS))
def test_mesh_band_replays_equal_eager(stub_graphs, case, n):
    """The mesh band through its program (captured on the first frame,
    replayed on the second: no capture) equals the eager mesh band and the
    one-device render bit for bit."""
    scene, size, kw = BANDS[case]
    _, _, data, meta, cset = shared_inputs(scene)
    cam = meta.cameras[0]
    if size is not None:
        cam = dataclasses.replace(cam, width=size[0], height=size[1])
    with stub_graphs.eager():
        single = _render(data, meta, cam, cset, **kw)
        want = _render(data, meta, cam, cset, _mesh(n), **kw)
    assert not stub_graphs._scenes
    c0 = stub_graphs.stats["captures"]
    got = _render(data, meta, cam, cset, _mesh(n), **kw)
    c1 = stub_graphs.stats["captures"]
    again = _render(data, meta, cam, cset, _mesh(n), **kw)
    assert c1 > c0 and stub_graphs.stats["captures"] == c1
    progs = stub_graphs.scene_programs(data, meta, cset, "cpu")
    assert any(k[0] == "frame" and k[-1] == _mesh(n) for k in progs)
    assert got.shape == (cam.height, cam.width, 3)
    for img in (got, again, single):
        assert torch.equal(img, want)


@pytest.mark.parametrize("n,shared,chunk", [
    (2, True, 1 << 22), (8, True, 1 << 22), (2, False, 1 << 22),
    (2, True, 200)])
def test_render_rays_sharded_replays_equal_eager(stub_graphs, n, shared,
                                                 chunk):
    """The sharded wavefront (each shard's wavefront programs on its
    device's scene, shards of one size sharing them) equals the same call
    under eager() bit for bit: shared and per-ray origins, and shards cut
    into 128-ray chunks; a second call captures nothing."""
    from raytracer_tpu_torch.models.whitted import _tile_order
    from raytracer_tpu_torch.ops.camera import camera_vectors, eye_rays_from
    from raytracer_tpu_torch.ops.tiling import apply_tile_order
    from raytracer_tpu_torch.parallel.render import render_rays_sharded

    _, _, data, meta, cset = shared_inputs("terrain16")
    cam = dataclasses.replace(meta.cameras[0], width=32, height=32)
    origin, dirs = eye_rays_from(torch.from_numpy(camera_vectors(cam)), 32, 32)
    blocks, perm, _ = _tile_order(32, 32, "cpu")
    dirs = apply_tile_order(dirs, 32, 32, blocks, perm).contiguous()
    if not shared:
        origin = origin.expand(dirs.shape).contiguous()
    args = (data, meta, origin, dirs, _mesh(n), cset, "cluster")
    with stub_graphs.eager():
        want = render_rays_sharded(*args, chunk=chunk)
    got = render_rays_sharded(*args, chunk=chunk)
    c1 = stub_graphs.stats["captures"]
    assert c1 > 0 and stub_graphs.cached(data) > 0
    assert torch.equal(render_rays_sharded(*args, chunk=chunk), want)
    assert torch.equal(got, want) and stub_graphs.stats["captures"] == c1


def test_inplace_edit_captures_mesh_band_anew(stub_graphs):
    """A scene tensor edited in place keys new programs on the mesh too:
    the next frame captures anew and equals the eager render of the edited
    scene."""
    _, _, pdata, meta, cset = shared_inputs("terrain16")
    data = dataclasses.replace(pdata, light_pos=pdata.light_pos.clone())
    cam = dataclasses.replace(meta.cameras[0], width=32, height=32)
    mesh = _mesh(2)
    _render(data, meta, cam, cset, mesh)
    c1 = stub_graphs.stats["captures"]
    _render(data, meta, cam, cset, mesh)
    assert stub_graphs.stats["captures"] == c1
    data.light_pos.add_(torch.tensor([3.0, 1.0, -2.0]))
    got = _render(data, meta, cam, cset, mesh)
    assert stub_graphs.stats["captures"] > c1
    with stub_graphs.eager():
        assert torch.equal(got, _render(data, meta, cam, cset, mesh))


def _two_devices():
    """A mesh whose second shard lies on the ``meta`` device: it stands in
    for a second card where only the copies' identity is checked."""
    from raytracer_tpu_torch.parallel.mesh import Mesh

    return Mesh((torch.device("cpu"), torch.device("meta")))


def test_replicate_keeps_copies(stub_graphs):
    """``replicate`` hands the object itself to the shard on its device
    and one kept copy to the other (the same copy call after call, for a
    scene, its clusters and a tensor), a new copy after an in-place edit,
    and a new one after ``programs.drop`` or ``programs.clear``; drop
    forgets the copies of the scene's accelerator too."""
    from raytracer_tpu_torch.models.bvh import build_bvh
    from raytracer_tpu_torch.models.clusters import build_clusters
    from raytracer_tpu_torch.parallel.mesh import replicate

    data, meta = port_scene("entry")
    cset = build_clusters(data, meta, build_bvh(data, meta))
    mesh = _two_devices()
    here, there = replicate(mesh, data)
    assert here is data and there.vertices.device.type == "meta"
    assert replicate(mesh, data)[1] is there
    cs_there = replicate(mesh, cset)[1]
    assert replicate(mesh, cset)[1] is cs_there
    t = torch.ones(3)
    assert replicate(mesh, t)[1] is replicate(mesh, t)[1]
    assert replicate(mesh, None) == (None, None)
    data.mat_diffuse.mul_(1.0)                 # a new version, same values
    edited = replicate(mesh, data)[1]
    assert edited is not there and replicate(mesh, data)[1] is edited
    stub_graphs.scene_programs(data, meta, cset, "cpu")
    stub_graphs.drop(data)
    assert replicate(mesh, data)[1] is not edited
    assert replicate(mesh, cset)[1] is not cs_there
    kept = replicate(mesh, t)[1]
    stub_graphs.clear()
    assert replicate(mesh, t)[1] is not kept


def test_server_eviction_drops_replicas(stub_graphs, tmp_path):
    """The render server's LRU evicts a scene with ``programs.drop``: the
    scene's programs go, and with them the replicas of its data and of its
    clusters."""
    import shutil

    from raytracer_tpu_torch.parallel.mesh import replicate
    from raytracer_tpu_torch.serve import RenderServer

    server = RenderServer(max_scenes=1, device="cpu")
    xmls = [str(tmp_path / f"{k}.xml") for k in "ab"]
    for x in xmls:
        shutil.copy(ENTRY_XML, x)
    data, meta, cset = server._load(xmls[0], "cluster")
    for obj in (data, cset):
        replicate(_two_devices(), obj)
    stub_graphs.scene_programs(data, meta, cset, "cpu")
    ids = {id(data), id(cset)}
    assert {k[0] for k in stub_graphs._replicas} == ids
    server._load(xmls[1], "cluster")
    assert not stub_graphs._replicas and stub_graphs.cached(data) == 0


_WORKER = textwrap.dedent(
    """
    import contextlib, dataclasses, os, sys
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank, store, repo, device, engine = (int(sys.argv[1]), sys.argv[2],
                                         sys.argv[3], sys.argv[4], sys.argv[5])
    sys.path.insert(0, os.path.join(repo, "tests"))
    from raytracer_tpu_torch.models import programs

    if device == "cpu":
        # the captures' stand-in: replays run the bodies again
        from torch_port_util import StubGraph

        programs.graph_class = lambda d: (None if programs._eager[0]
                                          else StubGraph)
    else:
        # index_add_'s float atomics would differ between two runs
        torch.use_deterministic_algorithms(True)
    from raytracer_tpu_torch.parallel.distributed import initialize

    assert initialize(f"file://{store}", 2, rank) == rank
    assert dist.get_backend() == "gloo"

    from raytracer_tpu_torch.models.bvh import build_bvh, device_bvh
    from raytracer_tpu_torch.models.clusters import build_clusters
    from raytracer_tpu_torch.models.whitted import _tile_order, render_rays
    from raytracer_tpu_torch.ops.camera import camera_vectors, eye_rays_from
    from raytracer_tpu_torch.ops.tiling import apply_tile_order
    from raytracer_tpu_torch.parallel.mesh import make_mesh, mesh_from_arg
    from raytracer_tpu_torch.parallel.render import render_rays_sharded
    from raytracer_tpu_torch.parallel.train import init_state, make_train_step
    from raytracer_tpu_torch.pipeline import render_one_camera
    from raytracer_tpu_torch.utils.synth import terrain_scene

    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    data, meta = terrain_scene(cells=16, res=32, mirror_stripes=True,
                               device=dev)
    # the engine's accelerator (named cs whatever the engine)
    cs = (build_clusters(data, meta, build_bvh(data, meta))
          if engine == "cluster"
          else device_bvh(build_bvh(data, meta, ordered=True), dev))
    one = mesh_from_arg("auto", device)            # a shard a process: 2
    wide = make_mesh(devices=[dev, dev])           # 2 a process: 4
    assert (one.size, one.world, wide.size) == (2, 2, 4)
    captures = lambda: programs.stats["captures"]  # noqa: E731

    def frame(cam, mesh, **kw):
        img = render_one_camera(data, meta, cam, cs, device=dev, mesh=mesh,
                                engine=engine, **kw)[0]
        return torch.from_numpy(img)

    # frames: parity and jitter at --ssaa 2, 75 rows (the last band padded
    # with virtual rows on both meshes)
    cam = meta.cameras[0]
    for kw in (dict(ssaa=2), dict(ssaa=2, ssaa_mode="jitter", seed=4),
               dict(cam=dataclasses.replace(cam, height=75))):
        c = kw.pop("cam", cam)
        with programs.eager():
            single = frame(c, None, **kw)
        for mesh in (one, wide):
            c0 = captures()
            got = frame(c, mesh, **kw)
            c1 = captures()
            again = frame(c, mesh, **kw)
            assert c1 > c0 and captures() == c1, (kw, mesh)
            with programs.eager():
                want = frame(c, mesh, **kw)
            for img in (got, again, single):
                assert torch.equal(img, want), (kw, mesh)

    # the sharded wavefront: this process's slices, replayed and eager
    origin, dirs = eye_rays_from(
        torch.from_numpy(camera_vectors(cam)).to(dev), 32, 32)
    blocks, perm, _ = _tile_order(32, 32, dev, engine)
    dirs = apply_tile_order(dirs, 32, 32, blocks, perm).contiguous()
    for mesh in (one, wide):
        got = render_rays_sharded(data, meta, origin, dirs, mesh, cs, engine)
        with programs.eager():
            want = render_rays_sharded(data, meta, origin, dirs, mesh, cs,
                                       engine)
        assert got.shape[0] == 1024 // 2 and torch.equal(got, want)

    # the train step on the 4-shard mesh: the two-step program (captured
    # on step 1) against the eager step, 3 steps bit for bit; the program's
    # loss and gradient buffers stay put across its replays
    with torch.no_grad():
        target = render_rays(data, meta, origin, dirs, cs, engine=engine)
    bad = dataclasses.replace(data, mat_diffuse=data.mat_diffuse * 0.5,
                              light_int=data.light_int * 0.7)
    fields = ("mat_diffuse", "light_int", "light_pos", "vertices")
    runs = {}
    for graphs in (True, False):
        state = init_state(bad, fields=fields)
        step = make_train_step(meta, lr=1e-2, engine=engine, device=dev,
                               mesh=wide)
        c0, got, ptrs = captures(), [], set()
        with contextlib.nullcontext() if graphs else programs.eager():
            for _ in range(3):
                state, loss = step(state, bad, origin, dirs, target, accel=cs)
                got.append([loss.clone()] + [
                    x.detach().clone() for p in state.params.values()
                    for x in (p.grad, p)])
                if graphs:
                    (prog,) = step.programs.values()
                    ptrs.add(tuple(x.data_ptr() for x in [prog.loss] + [
                        p.grad for p in state.params.values()]))
        # the visibility pass's steps come first on the BVH engine
        assert (captures() > c0 + 2 if engine == "bvh" and graphs
                else captures() == c0 + 2 * graphs), captures() - c0
        assert len(ptrs) == graphs, ptrs
        runs[graphs] = got
    for i, (a, b) in enumerate(zip(runs[True], runs[False])):
        for x, y in zip(a, b):
            assert torch.equal(x, y), f"step {i + 1}"
    assert all(bool(torch.isfinite(r[0])) for r in runs[True])
    flat = torch.cat([x.flatten() for x in runs[True][-1]]).cpu()
    both = [torch.empty_like(flat) for _ in range(2)]
    dist.all_gather(both, flat)
    assert torch.equal(both[0], both[1]), "the ranks' steps differ"
    dist.barrier()
    print(f"rank {rank}: ok", flush=True)
    """
)


def run_two_ranks(tmp_path, device: str, timeout: int = 300,
                  engine: str = "cluster") -> None:
    """``_WORKER`` in two processes on ``device`` through ``engine`` (gloo
    over a file store); both must print their ok line and exit 0."""
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        env.pop(var, None)
    store = str(tmp_path / "store")
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(r), store, REPO, device, engine],
        env=env,
        cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out}"
        assert f"rank {r}: ok" in out


def test_two_processes_replay(tmp_path):
    run_two_ranks(tmp_path, "cpu")


@pytest.mark.parametrize("scene", ["entry", "terrain16"])
@pytest.mark.parametrize("mode", ["parity", "jitter"])
def test_program_route_meets_jax_mesh_bars(stub_graphs, scene, mode):
    """test_torch_parallel's bars against the JAX package's 8-device mesh
    render, through the mesh band program: its render captures."""
    c0 = stub_graphs.stats["captures"]
    getattr(test_torch_parallel, f"test_mesh_matches_jax_mesh_{mode}")(scene)
    assert stub_graphs.stats["captures"] > c0
