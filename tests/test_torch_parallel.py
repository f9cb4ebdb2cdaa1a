"""The port's device mesh (``parallel/mesh.py``, ``parallel/render.py``,
``parallel/scaling.py``, the mesh through ``render_camera_streamed`` and
``render_one_camera``, the sharded ``make_train_step`` and the CLIs'
``--mesh``) on an 8-shard mesh of the CPU (logical shards, the analog of
the JAX package's forced 8-device CPU platform).

Bars: bit for bit against the port's own single-device paths; against
the JAX package's 8-device mesh path the image bars (at most 4 pixels >
1 LSB, fewer than 1%), in jitter mode with the port's own draws (JAX's);
the sharded step's loss to rtol 1e-5 and each field's gradient within
1e-3 of its max against one device, and the bars of test_torch_train
against the JAX ``pmean``'d step."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_port_util import (
    ENTRY_XML, bad_pixels, jax_accel, shared_inputs,
)


def _mesh(n=8):
    from raytracer_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(devices=["cpu"] * n)


def _cam(pmeta, w=None, h=None):
    cam = pmeta.cameras[0]
    return dataclasses.replace(cam, width=w or cam.width, height=h or cam.height)


def test_make_mesh_and_mesh_from_arg():
    from raytracer_tpu_torch.parallel.mesh import (
        Mesh, make_mesh, mesh_from_arg, replicate, shard_rays,
    )

    mesh = _mesh()
    assert mesh == Mesh((torch.device("cpu"),) * 8, 0, 1) and mesh.size == 8
    assert make_mesh(devices=["cpu"] * 8, n=3).size == 3
    with pytest.raises(ValueError, match="need 9 devices, have 8"):
        make_mesh(devices=["cpu"] * 8, n=9)
    with pytest.raises(ValueError, match="need 1 devices, have 0"):
        make_mesh()          # no card here
    assert mesh_from_arg("auto", "cpu") is None
    assert mesh_from_arg("1", "cpu") is None
    assert mesh_from_arg("8", "cpu") == mesh
    with pytest.raises(ValueError):
        mesh_from_arg("0", "cpu")
    x = torch.arange(32.0).reshape(16, 2)
    parts = shard_rays(mesh, x)
    assert len(parts) == 8 and all(torch.equal(p, x[2 * i:2 * i + 2])
                                   for i, p in enumerate(parts))
    with pytest.raises(ValueError, match="do not divide"):
        shard_rays(mesh, x[:15])
    _, _, pdata, _, pcs = shared_inputs("entry")
    assert pdata.to("cpu") is pdata and pcs.to("cpu") is pcs
    assert all(r is pdata for r in replicate(mesh, pdata))
    assert replicate(mesh, None) == (None,) * 8


def test_mesh_from_arg_on_cards(monkeypatch):
    """``auto`` is every card, N the first N, raising when there are fewer
    (a machine with 2 cards, simulated)."""
    from raytracer_tpu_torch.parallel.mesh import make_mesh, mesh_from_arg

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    cards = (torch.device("cuda", 0), torch.device("cuda", 1))
    assert make_mesh().devices == cards
    assert mesh_from_arg("auto", "cuda").devices == cards
    assert mesh_from_arg("2", "cuda").devices == cards
    assert mesh_from_arg("1", "cuda") is None
    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        mesh_from_arg("4", "cuda")


@pytest.mark.parametrize("engine", ["brute", "cluster"])
@pytest.mark.parametrize("scene", ["entry", "terrain16"])
def test_render_rays_sharded_equals_render_rays(scene, engine):
    from raytracer_tpu_torch.models.whitted import _tile_order, render_rays
    from raytracer_tpu_torch.ops.camera import camera_vectors, eye_rays_from
    from raytracer_tpu_torch.ops.tiling import apply_tile_order
    from raytracer_tpu_torch.parallel.render import render_rays_sharded

    _, _, pdata, pmeta, pcs = shared_inputs(scene)
    cam = _cam(pmeta, 32, 32)
    origin, dirs = eye_rays_from(torch.from_numpy(camera_vectors(cam)), 32, 32)
    blocks, perm, _ = _tile_order(32, 32, "cpu", engine)
    dirs = apply_tile_order(dirs, 32, 32, blocks, perm).contiguous()
    accel = pcs if engine == "cluster" else None
    want = render_rays(pdata, pmeta, origin, dirs, accel, engine=engine)
    got = render_rays_sharded(pdata, pmeta, origin, dirs, _mesh(), accel, engine)
    assert torch.equal(got, want)


@pytest.mark.parametrize("w,h", [(40, 24), (20, 13)])
def test_render_camera_sharded(w, h):
    """40x24 (the 8x16 blocks do not divide it: the permutation) and 20x13
    (260 rays: 4 padded to divide the 8 shards) equal render_camera bit
    for bit."""
    from raytracer_tpu_torch.models.whitted import render_camera
    from raytracer_tpu_torch.parallel.render import render_camera_sharded

    _, _, pdata, pmeta, pcs = shared_inputs("entry")
    cam = _cam(pmeta, w, h)
    got = render_camera_sharded(pdata, pmeta, cam, _mesh(), pcs, "cluster")
    want = render_camera(pdata, pmeta, cam, pcs, device="cpu").numpy()
    assert got.shape == (h, w, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["parity", "mean"])
@pytest.mark.parametrize("scene", ["entry", "terrain16"])
def test_render_one_camera_mesh_bitwise(scene, mode, monkeypatch):
    """The 8-shard mesh at --ssaa 2 equals one device bit for bit; each
    band's rays are traced as 8 wavefronts of whole blocks."""
    from raytracer_tpu_torch.models import whitted
    from raytracer_tpu_torch.pipeline import render_one_camera

    _, _, pdata, pmeta, pcs = shared_inputs(scene)
    cam = _cam(pmeta)
    single, _ = render_one_camera(pdata, pmeta, cam, pcs, ssaa=2,
                                  ssaa_mode=mode, device="cpu")
    traced = []
    call = whitted._Shard.__call__
    monkeypatch.setattr(whitted._Shard, "__call__", lambda self:
                        traced.append(self.src.shape[0]) or call(self))
    sharded, _ = render_one_camera(pdata, pmeta, cam, pcs, ssaa=2,
                                   ssaa_mode=mode, device="cpu", mesh=_mesh())
    assert traced == [64 * 64 * 4 // 8] * 8
    np.testing.assert_array_equal(sharded, single)


def test_mesh_dropped(monkeypatch):
    """As in the JAX pipeline, a scaled width off the 16-pixel block and the
    adaptive mode render on one device."""
    from raytracer_tpu_torch.models import whitted
    from raytracer_tpu_torch.pipeline import render_one_camera

    _, _, pdata, pmeta, pcs = shared_inputs("entry")
    meshes = []
    call = whitted._Frame.__call__
    monkeypatch.setattr(whitted._Frame, "__call__", lambda self, *a:
                        meshes.append(getattr(self, "mesh", None))
                        or call(self, *a))
    render_one_camera(pdata, pmeta, _cam(pmeta, 20, 16), pcs, device="cpu",
                      mesh=_mesh())
    img, stats = render_one_camera(pdata, pmeta, _cam(pmeta, 16, 16), pcs,
                                   ssaa_mode="adaptive", device="cpu",
                                   mesh=_mesh())
    assert meshes == [None] and stats is not None
    render_one_camera(pdata, pmeta, _cam(pmeta, 16, 16), pcs, device="cpu",
                      mesh=_mesh())
    assert meshes[-1] is not None


@pytest.mark.parametrize("height", [144, 150])
@pytest.mark.parametrize("scene", ["entry", "terrain16"])
def test_mesh_streamed_band_padding(scene, height, monkeypatch):
    """A frame whose height the aligned band (lcm(16, 8 rows x 8 shards) =
    64 rows) does not divide: the last band takes virtual rows below the
    frame, rendered and cropped, and the image is the single-device one bit
    for bit; at 150 rows the boundary lies inside a tile block (the port's
    copy of tests/test_cli_mesh.py's padding case, on in-repo scenes)."""
    from raytracer_tpu_torch.models import whitted

    _, _, pdata, pmeta, pcs = shared_inputs(scene)
    cam = _cam(pmeta, 128, height)
    single = whitted.render_camera_streamed(pdata, pmeta, cam, pcs, device="cpu")
    bands = []
    call = whitted._Frame.__call__
    monkeypatch.setattr(whitted._Frame, "__call__", lambda self, *a:
                        bands.append(self.bh) or call(self, *a))
    sharded = whitted.render_camera_streamed(pdata, pmeta, cam, pcs,
                                             device="cpu", mesh=_mesh())
    assert bands == [192]
    assert tuple(sharded.shape) == (height, 128, 3)
    assert torch.equal(sharded, single)


def _jax_mesh_render(scene, **kw):
    from raytracer_tpu.parallel.mesh import make_mesh
    from raytracer_tpu.pipeline import render_one_camera

    jdata, jcs, _, _, _ = shared_inputs(scene)
    _, meta, _, _ = jax_accel(scene)
    mesh = make_mesh()
    assert mesh.size == 8
    img, _ = render_one_camera(jdata, meta, meta.cameras[0], jcs,
                               engine="cluster", ssaa=2, mesh=mesh, **kw)
    return img


def _image_bars(a, b):
    n_bad = bad_pixels(a, b)
    assert a.shape == b.shape
    assert n_bad <= 4 and n_bad < 0.01 * a.shape[0] * a.shape[1], n_bad


@pytest.mark.parametrize("scene", ["entry", "terrain16"])
def test_mesh_matches_jax_mesh_parity(scene):
    from raytracer_tpu_torch.pipeline import render_one_camera

    _, _, pdata, pmeta, pcs = shared_inputs(scene)
    got, _ = render_one_camera(pdata, pmeta, _cam(pmeta), pcs, ssaa=2,
                               device="cpu", mesh=_mesh())
    _image_bars(got, _jax_mesh_render(scene))


@pytest.mark.parametrize("scene", ["entry", "terrain16"])
def test_mesh_matches_jax_mesh_jitter(scene):
    """Jitter under one seed, over bands of a chunk that makes 16-row
    bands on one device: on the 8-shard mesh the port draws for JAX's mesh
    bands (64 rows: rows 0 and 64), the JAX samples, and meets the image
    bars against the JAX mesh render."""
    from raytracer_tpu_torch.models.whitted import render_camera_streamed
    from raytracer_tpu_torch.ops.camera import recorded_jitter

    _, _, pdata, pmeta, pcs = shared_inputs(scene)
    cam = _cam(pmeta)
    chunk = cam.width * 2 * 16 + 5
    keys = []
    draw, _ = recorded_jitter(3)
    got = render_camera_streamed(
        pdata, pmeta, cam, pcs, chunk=chunk, ssaa=2, ssaa_mode="jitter",
        device="cpu", mesh=_mesh(),
        jitter=lambda k, s: keys.append(k) or draw(k, s)).numpy()
    assert keys == [("band", 0), ("band", 64)]
    _image_bars(got, _jax_mesh_render(scene, ssaa_mode="jitter", seed=3,
                                      chunk=chunk))


def _train_problem(res=32):
    """(perturbed port data, meta, clusters, origin, dirs, target) of
    terrain16 at res x res: the target the true scene's radiance, the start
    mat_diffuse x 0.5 and light_int x 0.7."""
    from raytracer_tpu_torch.models.whitted import render_rays
    from raytracer_tpu_torch.ops.camera import camera_vectors, eye_rays_from

    _, _, pdata, pmeta, pcs = shared_inputs("terrain16")
    cam = _cam(pmeta, res, res)
    origin, dirs = eye_rays_from(torch.from_numpy(camera_vectors(cam)), res, res)
    with torch.no_grad():
        target = render_rays(pdata, pmeta, origin, dirs, pcs, engine="cluster")
    bad = dataclasses.replace(pdata, mat_diffuse=pdata.mat_diffuse * 0.5,
                              light_int=pdata.light_int * 0.7)
    return bad, pmeta, pcs, origin, dirs, target


def test_sharded_train_step_matches_one_device():
    """Step 1 on 8 shards against one device (loss to rtol 1e-5, each
    field's gradient within 1e-3 of its max |g|), and the loss falls over
    10 sharded steps."""
    from raytracer_tpu_torch.parallel.train import init_state, make_train_step

    bad, pmeta, pcs, origin, dirs, target = _train_problem()
    fields = ("mat_diffuse", "light_int", "light_pos")
    got = []
    for mesh in (None, _mesh()):
        state = init_state(bad, fields=fields)
        step = make_train_step(pmeta, lr=3e-2, engine="cluster", device="cpu",
                               mesh=mesh)
        state, loss = step(state, bad, origin, dirs, target, accel=pcs)
        got.append((float(loss), {f: p.grad.clone() for f, p in
                                  state.params.items()}, state, step))
    (l1, g1, _, _), (l8, g8, state, step) = got
    assert abs(l8 - l1) <= 1e-5 * abs(l1)
    for f in fields:
        assert float((g8[f] - g1[f]).abs().max()) <= 1e-3 * float(g1[f].abs().max()), f
    losses = [l8]
    for _ in range(9):
        state, loss = step(state, bad, origin, dirs, target, accel=pcs)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < 0.5 * losses[0], losses


def test_sharded_train_step_matches_jax_pmean():
    """3 steps of the port's 8-shard step against the JAX package's
    ``make_train_step(meta, make_mesh(), adam)`` on its 8 CPU devices (the
    pmean'd step), from the same start: the bars of test_torch_train
    (losses and params to rtol 1e-4, the moments to 1e-3 of their max)."""
    import jax
    import jax.numpy as jnp
    import optax

    from raytracer_tpu.parallel.mesh import make_mesh, ray_sharding
    from raytracer_tpu.parallel.train import init_state as jinit
    from raytracer_tpu.parallel.train import make_train_step as jstep
    from raytracer_tpu_torch.parallel.train import init_state, make_train_step
    from test_torch_train import FIELDS, _assert_states_close, _jax_numpy, _setup

    jdata, pdata, meta, pmeta, origin, dirs, target = _setup()
    mesh = make_mesh()
    step = jstep(meta, mesh, optax.adam(1e-2), engine="brute", ldr=True)
    shard = ray_sharding(mesh)
    jd, jt = (jax.device_put(jnp.asarray(x), shard) for x in (dirs, target))
    state = jinit(jdata, optax.adam(1e-2), fields=FIELDS)
    jl = []
    for _ in range(3):
        state, loss = step(state, jax.device_put(jdata), jnp.asarray(origin),
                           jd, jt)
        jl.append(float(loss))
    port = init_state(pdata, fields=FIELDS)
    pstep = make_train_step(pmeta, lr=1e-2, engine="brute", ldr=True,
                            device="cpu", mesh=_mesh())
    pl = []
    for _ in range(3):
        port, loss = pstep(port, pdata, torch.from_numpy(origin),
                           torch.from_numpy(dirs), torch.from_numpy(target))
        pl.append(float(loss))
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    _assert_states_close(port, _jax_numpy(state), 1e-4, "after 3 sharded steps")


def test_measure_scaling_runs():
    from raytracer_tpu_torch.ops.camera import camera_vectors, eye_rays_from
    from raytracer_tpu_torch.parallel.scaling import measure_scaling

    _, _, pdata, pmeta, pcs = shared_inputs("entry")
    cam = _cam(pmeta, 32, 32)
    origin, dirs = eye_rays_from(torch.from_numpy(camera_vectors(cam)), 32, 32)
    pts = measure_scaling(pdata, pmeta, origin, dirs, pcs, "cluster",
                          sizes=[1, 2, 4], frames=1, device="cpu")
    assert [p.n_devices for p in pts] == [1, 2, 4]
    assert pts[0].efficiency == 1.0
    assert all(p.rays_per_s > 0 and p.seconds_per_frame > 0 for p in pts)


def test_cli_mesh_bitwise(tmp_path, capsys):
    """``--device cpu --mesh 4`` writes the very PPM of ``--mesh 1``."""
    from raytracer_tpu_torch.render import main
    from raytracer_tpu_torch.utils.ppm import read_ppm

    common = [ENTRY_XML, "--device", "cpu", "--engine", "cluster"]
    main(common + ["--mesh", "1", "--out-dir", str(tmp_path / "one")])
    assert "Rendering with" not in capsys.readouterr().out
    main(common + ["--mesh", "4", "--out-dir", str(tmp_path / "four")])
    assert "Rendering with 4 devices (cpu)." in capsys.readouterr().out
    a = read_ppm(str(tmp_path / "one" / "entry_scene.ppm"))
    b = read_ppm(str(tmp_path / "four" / "entry_scene.ppm"))
    assert a.shape == (64, 64, 3)
    np.testing.assert_array_equal(a, b)


def test_train_cli_mesh_trims_and_rounds(tmp_path, capsys):
    """The train CLI on a 3-shard CPU mesh: a 32x32 frame (1,024 rays)
    drops its last ray once; ``--batch 100`` is rounded down to 99; the
    losses fall either way."""
    from raytracer_tpu_torch.models.scene import load_scene
    from raytracer_tpu_torch.models.whitted import render_camera
    from raytracer_tpu_torch.ops.image import quantize
    from raytracer_tpu_torch.train import main
    from raytracer_tpu_torch.utils.ppm import write_ppm

    data, meta = load_scene(ENTRY_XML, device="cpu")
    target = str(tmp_path / "t.ppm")
    with torch.no_grad():
        write_ppm(target, quantize(render_camera(
            data, meta, _cam(meta, 32, 32), None, device="cpu",
            engine="brute")).numpy())
    xml = str(tmp_path / "wrong.xml")
    with open(ENTRY_XML) as f:
        text = f.read()
    with open(xml, "w") as f:
        f.write(text.replace("0.8 0.4 0.2", "0.4 0.2 0.1"))
    common = [xml, "--target", target, "--downscale", "2", "--device", "cpu",
              "--mesh", "3", "--engine", "brute", "--steps", "3",
              "--log-every", "1", "--lr", "0.05"]
    import re

    for extra, note in (([], "dropping 1 of 1024 rays"), (["--batch", "100"], None)):
        main(common + extra)
        out = capsys.readouterr().out
        assert "Training on 3 device(s) (cpu)" in out
        assert (note in out) if note else "dropping" not in out
        losses = [float(x) for x in re.findall(r"loss ([0-9.]+)", out)]
        assert losses[-1] < losses[0], out
