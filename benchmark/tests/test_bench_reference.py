"""The plain reference against the port on the CPU (its plain kernel
versions, ``device="cpu"``) at small sizes: both configurations'
generators, whole frames, and one training step."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import small_config

from benchmark import imagecheck, sceneio
from benchmark.drivers import train as train_driver
from benchmark.reference import train as ref_train
from benchmark.reference import whitted as ref


def _port(xml):
    from raytracer_tpu_torch.models.scene import load_scene
    from raytracer_tpu_torch.render import engine_accel

    data, meta = load_scene(xml, device="cpu")
    return data, meta, engine_accel("auto", None, data, meta, "cpu")


@pytest.mark.parametrize("name", ["horse31k", "marbles650"])
def test_frames_match_the_port(bench, tmp_path, name):
    from raytracer_tpu_torch.pipeline import render_one_camera

    parsed = sceneio.generate(bench, small_config(bench, name), 2**31 + 1)
    xml = str(tmp_path / "s.xml")
    sceneio.write_xml(parsed, xml)
    data, meta, accel = _port(xml)
    scene = ref.Scene(parsed, "cpu")
    for i, cam in enumerate(parsed["cameras"]):
        for ssaa in (1, 2):
            img, _ = render_one_camera(data, meta, meta.cameras[i], accel,
                                       ssaa=ssaa, device="cpu")
            t = imagecheck.TILE
            tiles = [(r, c) for r in range(0, cam["height"], t)
                     for c in range(0, cam["width"], t)]
            got = ref.tiles_image(scene, cam, ssaa, tiles, t).numpy()
            full = np.zeros_like(img)
            for (r, c), x in zip(tiles, got):
                full[r:r + t, c:c + t] = x
            d = np.abs(full.astype(int) - img.astype(int))
            assert (d.max(-1) > 1).mean() <= 0.002, (name, i, ssaa)
            assert d.mean() <= 0.02


def test_training_steps_match_the_port(bench, tmp_path):
    from raytracer_tpu_torch.ops.camera import camera_vectors, eye_rays_from
    from raytracer_tpu_torch.parallel.train import init_state, make_train_step

    parsed = sceneio.generate(bench, small_config(bench, "horse31k"), 3)
    tr = bench.traffic("train-1m")
    cam = parsed["cameras"][0]
    scene = ref.Scene(parsed, "cpu")
    o, d, order = train_driver.reference_rays(cam, (16, 16), "cpu")
    with torch.no_grad():
        target, vis = ref.render(scene, o, d, group=256, record=True)
    start = train_driver.start_scene(parsed, tr["start_scale"])
    xml = str(tmp_path / "start.xml")
    sceneio.write_xml(start, xml)
    data, meta, accel = _port(xml)
    vec = torch.from_numpy(camera_vectors(meta.cameras[0]))
    origin, dirs = eye_rays_from(vec, cam["width"], cam["height"])
    raster = torch.empty_like(target)
    raster[order] = target
    state = init_state(data, fields=tuple(tr["fields"]))
    step = make_train_step(meta, lr=tr["lr"], engine="cluster", device="cpu")
    losses = []
    p0 = {k: p.detach().clone() for k, p in state.params.items()}
    for i in range(2):
        state, loss = step(state, data, origin, dirs, raster, accel)
        losses.append(float(loss))
        if i == 0:
            g1 = {k: state.opt.state[p]["exp_avg"] / 0.1
                  for k, p in state.params.items()}
    r_losses, r_g1, r_p = ref_train.train(ref.Scene(start, "cpu"), o, d,
                                          target, vis, tr["lr"], 2, 256)
    np.testing.assert_allclose(losses, r_losses, rtol=1e-5)
    for k, v in train_driver.LEAVES.items():
        np.testing.assert_allclose(g1[k].numpy(), r_g1[0][v].numpy(),
                                   rtol=1e-4, atol=1e-9)
        np.testing.assert_allclose(
            (state.params[k].detach() - p0[k]).numpy(),
            (r_p[v] - getattr(ref.Scene(start, "cpu"), v)).numpy(),
            rtol=1e-4, atol=1e-6)
