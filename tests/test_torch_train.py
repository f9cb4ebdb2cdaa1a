"""The port's training (``parallel/train.py``, the train-state checkpoints
of ``utils/checkpoint.py``, ``convert.train_state_*`` and the
``raytracer_tpu_torch.train`` CLI) against the JAX package's, on the CPU.

Bars: params after Adam steps within rtol 1e-4 of the JAX package's
(``torch.optim.Adam`` and optax ``adam`` round differently; the
gradients agree to ~1e-5), checkpoint leaves exactly equal across the
packages, and the CLI's batch draws the very same pixels.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from torch_port_util import ENTRY_XML, jax_accel, shared_inputs

# Adam divides each moment by its own scale, so a parameter whose true
# gradient is zero but whose computed one is rounding noise (the floor's
# vertices along its own plane) moves by +-lr on the noise's sign in
# either package: the comparison trains fields whose gradients are signal
FIELDS = ("light_int", "light_pos", "mat_diffuse", "mat_specular")


def _setup(name="entry", res=16):
    """(JAX data (perturbed), port data (the same), meta, port meta,
    origin, dirs, target): rays of the camera at res x res, the target the
    true scene's radiance, the start the diffuse albedo and light
    intensity off."""
    import jax.numpy as jnp

    from raytracer_tpu.models.whitted import render_rays
    from raytracer_tpu.ops.camera import eye_rays
    from raytracer_tpu_torch.convert import scene_from_numpy
    from torch_port_util import numpy_fields

    jdata, _, _, pmeta, _ = shared_inputs(name)
    _, meta, _, _ = jax_accel(name)
    cam = dataclasses.replace(meta.cameras[0], width=res, height=res)
    origin, dirs = (np.array(x, np.float32) for x in eye_rays(cam))
    target = np.array(render_rays(jdata, meta, jnp.asarray(origin),
                                  jnp.asarray(dirs), engine="brute"))
    bad = dataclasses.replace(jdata, mat_diffuse=jdata.mat_diffuse * 0.5,
                              light_int=jdata.light_int * 0.7)
    pbad = scene_from_numpy(numpy_fields(bad), "cpu")
    return bad, pbad, meta, pmeta, origin, dirs, target


def _jax_steps(state, data, meta, origin, dirs, target, n, lr=1e-2):
    """n steps of the JAX package's make_train_step (optax adam, a
    1-device CPU mesh): (state, losses)."""
    import jax
    import jax.numpy as jnp
    import optax

    from raytracer_tpu.parallel.mesh import make_mesh
    from raytracer_tpu.parallel.train import make_train_step

    step = make_train_step(meta, make_mesh(n=1), optax.adam(lr),
                           engine="brute", ldr=True)
    losses = []
    for _ in range(n):
        state, loss = step(state, jax.device_put(data), jnp.asarray(origin),
                           jnp.asarray(dirs), jnp.asarray(target))
        losses.append(float(loss))
    return state, losses


def _jax_numpy(state):
    """(params, count, mu, nu) numpy of a JAX TrainState."""
    adam = state.opt_state[0]
    as_np = lambda d: {k: np.asarray(v) for k, v in d.items()}
    return (as_np(state.params), np.asarray(adam.count), as_np(adam.mu),
            as_np(adam.nu))


def _port_steps(state, pdata, pmeta, origin, dirs, target, n, lr=1e-2):
    from raytracer_tpu_torch.parallel.train import make_train_step

    step = make_train_step(pmeta, lr=lr, engine="brute", ldr=True,
                           device="cpu")
    losses = []
    for _ in range(n):
        state, loss = step(state, pdata, torch.from_numpy(origin),
                           torch.from_numpy(dirs), torch.from_numpy(target))
        losses.append(float(loss))
    return state, losses


def _assert_states_close(port, jax_np, rtol, what):
    from raytracer_tpu_torch.convert import train_state_to_numpy

    pp, pc, pmu, pnu = train_state_to_numpy(port)
    jp, jc, jmu, jnu = jax_np
    assert int(pc) == int(jc), what
    for f in jp:
        np.testing.assert_allclose(pp[f], jp[f], rtol=rtol, atol=1e-6,
                                   err_msg=f"{what} param {f}")
        for a, b, m in ((pmu, jmu, "mu"), (pnu, jnu, "nu")):
            scale = float(np.abs(b[f]).max())
            np.testing.assert_allclose(a[f], b[f], rtol=1e-3,
                                       atol=1e-3 * scale + 1e-12,
                                       err_msg=f"{what} {m} {f}")


def test_adam_steps_match_jax():
    """One JAX step, its state carried into the port
    (convert.train_state_from_numpy), then three steps in each package:
    losses to rtol 1e-4, params to rtol 1e-4, the moments to 1e-3 of their
    field's max, the same count."""
    import optax

    from raytracer_tpu.parallel.train import init_state as jinit
    from raytracer_tpu_torch.convert import train_state_from_numpy

    jdata, pdata, meta, pmeta, origin, dirs, target = _setup()
    state, _ = _jax_steps(jinit(jdata, optax.adam(1e-2), fields=FIELDS), jdata,
                          meta, origin, dirs, target, 1)
    port = train_state_from_numpy(*_jax_numpy(state), device="cpu")
    assert list(port.params) == sorted(FIELDS)
    state, jl = _jax_steps(state, jdata, meta, origin, dirs, target, 3)
    port, pl = _port_steps(port, pdata, pmeta, origin, dirs, target, 3)
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    _assert_states_close(port, _jax_numpy(state), 1e-4, "after 3 steps")


def test_checkpoints_cross_packages(tmp_path):
    """A train-state npz written by the JAX package resumes in the port with
    its very leaves, one written by the port loads in the JAX package's
    load_train_state with its very leaves, and the resumed steps agree."""
    import optax

    from raytracer_tpu.parallel.train import init_state as jinit
    from raytracer_tpu.utils.checkpoint import load_train_state as jload
    from raytracer_tpu.utils.checkpoint import save_train_state as jsave
    from raytracer_tpu_torch.convert import train_state_to_numpy
    from raytracer_tpu_torch.parallel.train import init_state
    from raytracer_tpu_torch.utils.checkpoint import (
        load_train_state, save_train_state,
    )

    jdata, pdata, meta, pmeta, origin, dirs, target = _setup()
    jfresh = jinit(jdata, optax.adam(1e-2), fields=FIELDS)
    state, _ = _jax_steps(jfresh, jdata, meta, origin, dirs, target, 2)
    jsave(str(tmp_path / "jax.npz"), state)
    port = load_train_state(str(tmp_path / "jax.npz"),
                            init_state(pdata, fields=FIELDS))
    got = train_state_to_numpy(port)
    for a, b in zip(got, _jax_numpy(state)):
        for k in (b if isinstance(b, dict) else [None]):
            x, y = (a, b) if k is None else (a[k], b[k])
            np.testing.assert_array_equal(x, y, err_msg=str(k))
    port, pl = _port_steps(port, pdata, pmeta, origin, dirs, target, 1)
    state, jl = _jax_steps(state, jdata, meta, origin, dirs, target, 1)
    np.testing.assert_allclose(pl, jl, rtol=1e-4)

    save_train_state(str(tmp_path / "port.npz"), port)
    back = jload(str(tmp_path / "port.npz"), jfresh)
    want = train_state_to_numpy(port)
    got = _jax_numpy(back)
    assert got[1].dtype == np.int32 and int(got[1]) == 3
    for a, b in zip(got, want):
        for k in (b if isinstance(b, dict) else [None]):
            x, y = (a, b) if k is None else (a[k], b[k])
            np.testing.assert_array_equal(x, y, err_msg=str(k))
    # a fresh port state saves count 0 and zero moments; shapes are checked
    save_train_state(str(tmp_path / "fresh.npz"), init_state(pdata, fields=FIELDS))
    fresh = _jax_numpy(jload(str(tmp_path / "fresh.npz"), jfresh))
    assert int(fresh[1]) == 0 and not any(v.any() for v in fresh[2].values())
    with pytest.raises(ValueError, match="leaf shape"):
        load_train_state(str(tmp_path / "jax.npz"),
                         init_state(pdata, fields=("light_int", "light_pos",
                                                   "mat_diffuse", "vertices")))


def _write_target(path, img):
    from raytracer_tpu_torch.utils.exr import write_exr
    from raytracer_tpu_torch.utils.png import write_png
    from raytracer_tpu_torch.utils.ppm import write_ppm

    ext = path.rsplit(".", 1)[-1]
    if ext == "exr":
        write_exr(path, img.astype(np.float32), half=False)
    else:
        q = np.clip(img, 0, 255).astype(np.uint8)
        (write_png if ext == "png" else write_ppm)(path, q)


@pytest.fixture(scope="module")
def perturbed_entry(tmp_path_factory):
    """(perturbed scene xml, the true scene's radiance at 32x32)."""
    from raytracer_tpu_torch.models.scene import load_scene
    from raytracer_tpu_torch.models.whitted import render_camera

    d = tmp_path_factory.mktemp("train")
    data, meta = load_scene(ENTRY_XML, device="cpu")
    cam = dataclasses.replace(meta.cameras[0], width=32, height=32)
    img = render_camera(data, meta, cam, None, device="cpu",
                        engine="brute").numpy()
    xml = open(ENTRY_XML).read()
    xml2, n = re.subn(r"<DiffuseReflectance>0.8 0.4 0.2</DiffuseReflectance>",
                      "<DiffuseReflectance>0.4 0.4 0.4</DiffuseReflectance>",
                      xml)
    assert n == 1
    path = str(d / "perturbed.xml")
    with open(path, "w") as f:
        f.write(xml2)
    return path, img


def _losses(text):
    return [float(m) for m in re.findall(r"loss (\d+\.\d+)", text)]


@pytest.mark.parametrize("fmt", ["ppm", "png", "exr"])
def test_train_cli(tmp_path, capsys, perturbed_entry, fmt):
    """The CLI on the CPU: the loss falls over 12 steps from a ppm, png or
    exr target, the checkpoint resumes for 4 more, and --out writes the
    recovered render."""
    from raytracer_tpu_torch.train import main
    from raytracer_tpu_torch.utils.ppm import read_ppm

    xml, img = perturbed_entry
    target = str(tmp_path / f"target.{fmt}")
    _write_target(target, img)
    ck, out = str(tmp_path / "state.npz"), str(tmp_path / "rec.ppm")
    args = [xml, "--target", target, "--downscale", "2", "--engine", "brute",
            "--device", "cpu", "--checkpoint", ck, "--log-every", "4"]
    main(args + ["--steps", "12"])
    first = capsys.readouterr().out
    assert "Training on 1 device(s) (cpu)" in first and os.path.exists(ck)
    losses = _losses(first)
    assert len(losses) == 4 and losses[-1] < losses[0] * 0.5, losses
    main(args + ["--steps", "4", "--out", out])
    second = capsys.readouterr().out
    assert f"Resumed train state from {ck}" in second
    assert _losses(second)[0] < losses[-1] * 1.01
    rec = read_ppm(out)
    assert rec.shape == (32, 32, 3)
    err = np.abs(rec.astype(float) - np.clip(img, 0, 255)).mean()
    assert err < 3.0, err


def test_train_cli_batch_draws_jax_pixels(tmp_path, capsys, perturbed_entry,
                                          monkeypatch):
    """--batch: the port's CLI draws the same pixel indices as the JAX
    package's for one --seed, and its first loss equals the JAX CLI's to
    rtol 1e-4 (the same rays, the same params)."""
    from raytracer_tpu.train import main as jmain
    from raytracer_tpu_torch.train import main as pmain

    xml, img = perturbed_entry
    target = str(tmp_path / "target.exr")
    _write_target(target, img)
    draws = {}
    real = np.random.default_rng

    class Recording:
        def __init__(self, seed, who):
            self.g, self.who = real(seed), who

        def choice(self, *a, **kw):
            x = self.g.choice(*a, **kw)
            draws.setdefault(self.who, []).append(x.copy())
            return x

    args = [xml, "--target", target, "--downscale", "2", "--engine", "brute",
            "--batch", "64", "--seed", "5", "--steps", "3", "--log-every", "1"]
    monkeypatch.setattr(np.random, "default_rng", lambda s: Recording(s, "jax"))
    jmain(args + ["--mesh", "1"])
    jl = _losses(capsys.readouterr().out)
    monkeypatch.setattr(np.random, "default_rng", lambda s: Recording(s, "port"))
    pmain(args + ["--device", "cpu"])
    pl = _losses(capsys.readouterr().out)
    assert len(draws["port"]) == len(draws["jax"]) == 3
    for a, b in zip(draws["port"], draws["jax"]):
        np.testing.assert_array_equal(a, b)
    assert len(pl) == len(jl) == 3
    np.testing.assert_allclose(pl[0], jl[0], rtol=1e-4)


def test_train_entry_points_need_cuda(monkeypatch, perturbed_entry, tmp_path):
    """Without a GPU the CLI and make_train_step raise unless the CPU is
    asked for."""
    from raytracer_tpu_torch.parallel.train import make_train_step
    from raytracer_tpu_torch.train import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    xml, img = perturbed_entry
    target = str(tmp_path / "t.exr")
    _write_target(target, img)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([xml, "--target", target, "--downscale", "2", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(None)
    make_train_step(None, device="cpu")
