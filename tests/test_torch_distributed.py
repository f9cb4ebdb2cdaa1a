"""The port's process group (``parallel/distributed.py``): the bring-up,
the single-process gather, and a true two-process run on the CPU (gloo
over a file store), whose every rank must render the single-process
image bit for bit, keep the same parameters bit for bit through sharded
training steps, and leave the CLI's image to rank 0."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_initialize_noop_without_configuration(monkeypatch):
    import torch.distributed as dist

    from raytracer_tpu_torch.parallel.distributed import initialize

    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert initialize() == 0
    assert initialize() == 0
    assert not dist.is_initialized()


def test_initialize_raises_when_bring_up_fails(tmp_path):
    """A configured bring-up that fails raises (no fallback to one
    process): an init method of no known rendezvous scheme."""
    import torch.distributed as dist

    from raytracer_tpu_torch.parallel.distributed import initialize

    with pytest.raises(RuntimeError, match="bring-up failed"):
        initialize(f"nowhere://{tmp_path}/store", 2, 0)
    assert not dist.is_initialized()


def test_assemble_image_single_process():
    from raytracer_tpu_torch.parallel.distributed import (
        all_mean, assemble_image, gather_rows,
    )
    from raytracer_tpu_torch.parallel.mesh import make_mesh

    x = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    for mesh in (None, make_mesh(devices=["cpu"] * 4)):
        got = assemble_image(x, mesh)
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, x.numpy())
        assert gather_rows(x, mesh) is x and all_mean(x, mesh) is x


_WORKER = textwrap.dedent(
    """
    import dataclasses, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    from raytracer_tpu_torch.parallel.distributed import initialize

    assert initialize(f"file://{store}", 2, rank) == rank
    assert initialize() == rank and dist.get_backend() == "gloo"

    from raytracer_tpu_torch.models.bvh import build_bvh
    from raytracer_tpu_torch.models.clusters import build_clusters
    from raytracer_tpu_torch.models.scene import load_scene
    from raytracer_tpu_torch.models.whitted import _tile_order, render_rays
    from raytracer_tpu_torch.ops.camera import camera_vectors, eye_rays_from
    from raytracer_tpu_torch.ops.tiling import apply_tile_order
    from raytracer_tpu_torch.parallel.distributed import assemble_image
    from raytracer_tpu_torch.parallel.mesh import make_mesh, mesh_from_arg
    from raytracer_tpu_torch.parallel.render import render_rays_sharded
    from raytracer_tpu_torch.parallel.train import init_state, make_train_step
    from raytracer_tpu_torch.pipeline import render_one_camera
    from raytracer_tpu_torch.render import main as cli

    xml = os.path.join(sys.argv[4], "tests", "data", "entry_scene.xml")
    data, meta = load_scene(xml, device="cpu")
    cs = build_clusters(data, meta, build_bvh(data, meta))
    mesh = mesh_from_arg("auto", "cpu")   # one shard a process
    assert mesh.size == 2 and mesh.rank == rank and mesh.world == 2
    wide = make_mesh(devices=["cpu", "cpu"])   # 2 shards a process: 4
    assert wide.size == 4

    # the sharded wavefront, each rank tracing only its slices
    cam = dataclasses.replace(meta.cameras[0], width=32, height=32)
    origin, dirs = eye_rays_from(torch.from_numpy(camera_vectors(cam)), 32, 32)
    blocks, perm, _ = _tile_order(32, 32, "cpu")
    dirs = apply_tile_order(dirs, 32, 32, blocks, perm).contiguous()
    want = render_rays(data, meta, origin, dirs, cs, engine="cluster")
    for m in (mesh, wide):
        local = render_rays_sharded(data, meta, origin, dirs, m, cs, "cluster")
        assert local.shape[0] == 1024 // 2
        assert np.array_equal(assemble_image(local, m), want.numpy())

    # the pipeline: parity at --ssaa 2, jitter, a padded 150-row frame
    for kw in (dict(ssaa=2), dict(ssaa=2, ssaa_mode="jitter", seed=4),
               dict(cam=dataclasses.replace(cam, width=64, height=150))):
        c = kw.pop("cam", meta.cameras[0])
        single, _ = render_one_camera(data, meta, c, cs, device="cpu", **kw)
        for m in (mesh, wide):
            img, _ = render_one_camera(data, meta, c, cs, device="cpu", mesh=m, **kw)
            assert np.array_equal(img, single), kw

    # sharded training: the same loss and parameters on both ranks
    with torch.no_grad():
        target = render_rays(data, meta, origin, dirs, cs, engine="cluster")
    bad = dataclasses.replace(data, mat_diffuse=data.mat_diffuse * 0.5)
    state = init_state(bad, fields=("mat_diffuse", "light_int", "light_pos"))
    step = make_train_step(meta, lr=1e-2, engine="cluster", device="cpu", mesh=wide)
    losses = []
    for _ in range(3):
        state, loss = step(state, bad, origin, dirs, target, accel=cs)
        losses.append(float(loss))
    one = init_state(bad, fields=("mat_diffuse", "light_int", "light_pos"))
    _, l1 = make_train_step(meta, lr=1e-2, engine="cluster", device="cpu")(
        one, bad, origin, dirs, target, accel=cs)
    assert abs(losses[0] - float(l1)) <= 1e-5 * abs(float(l1)), (losses, l1)
    assert losses[-1] < losses[0], losses
    flat = torch.cat([p.detach().flatten() for p in state.params.values()]
                     + [torch.tensor(losses)])
    both = [torch.empty_like(flat) for _ in range(2)]
    dist.all_gather(both, flat)
    assert torch.equal(both[0], both[1]), "the ranks' parameters differ"

    # the CLI: every rank renders, rank 0 alone writes
    cli([xml, "--device", "cpu", "--out-dir", os.path.join(out, f"rank{rank}")])
    dist.barrier()
    print(f"rank {rank}: ok", flush=True)
    """
)


def test_two_processes(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        env.pop(var, None)
    store = str(tmp_path / "store")
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(r), store, str(tmp_path), REPO],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out}"
        assert f"rank {r}: ok" in out
        assert "Rendering with 2 devices (cpu)." in out
    assert (tmp_path / "rank0" / "entry_scene.ppm").exists()
    assert not (tmp_path / "rank1" / "entry_scene.ppm").exists()
