"""The port's streamed band renderer (``render_camera_streamed``) and
jittered sampling: against the port's own whole frame (bit for bit) and
against the JAX package's ``render_camera_streamed`` on the same clusters
(the image bars of test_torch_render: at most 4 pixels > 1 LSB; radiance
within rtol 1e-4 / atol 1e-3 on all but 4 pixels).  Jitter is compared
with nothing injected: the port draws the JAX package's sample sets."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_port_util import (
    bad_pixels, jax_accel, radiance_outside, shared_inputs,
)

# (width, height): the scene's 64x64, and 24x20, which the 8x16 blocks do
# not divide and whose last band is 4 rows at ssaa 1
CAMS = {"64x64": None, "24x20": (24, 20)}


def _cams(scene, cam_name):
    """(JAX camera, port camera) of ``scene`` resized to ``cam_name``."""
    _, meta, _, _ = jax_accel(scene)
    pmeta = shared_inputs(scene)[3]
    jcam, pcam = meta.cameras[0], pmeta.cameras[0]
    if CAMS[cam_name] is not None:
        w, h = CAMS[cam_name]
        jcam = dataclasses.replace(jcam, width=w, height=h)
        pcam = dataclasses.replace(pcam, width=w, height=h)
    return jcam, pcam


def _band_chunk(cam, ssaa):
    """A chunk that streams one lcm(16, ssaa)-row band at a time (not a
    multiple of 128)."""
    lcm = 16 * ssaa // np.gcd(16, ssaa)
    return cam.width * ssaa * lcm + 5


def _port_streamed(scene, cam, **kw):
    from raytracer_tpu_torch.models.whitted import render_camera_streamed

    _, _, pdata, pmeta, pcs = shared_inputs(scene)
    return render_camera_streamed(pdata, pmeta, cam, pcs, device="cpu", **kw).numpy()


def _jax_streamed(scene, cam, **kw):
    from raytracer_tpu.models.whitted import render_camera_streamed

    jdata, jcs, _, _, _ = shared_inputs(scene)
    _, meta, _, _ = jax_accel(scene)
    return np.asarray(render_camera_streamed(jdata, meta, cam, bvh=jcs,
                                             engine="cluster", **kw))


@pytest.mark.parametrize("cam_name", list(CAMS))
@pytest.mark.parametrize("mode", ["parity", "mean"])
@pytest.mark.parametrize("ssaa", [1, 2, 3])
def test_streamed_equals_whole_frame(ssaa, mode, cam_name, monkeypatch):
    """Several bands (a short last one on 24x20, rows not a multiple of the
    8-row block at ssaa 3) give the whole frame's image bit for bit: the
    SSAA reduction of ``render_camera``'s radiance, and render_one_camera's
    one band at the default chunk."""
    from raytracer_tpu_torch.models import whitted
    from raytracer_tpu_torch.ops.image import (
        downsample_mean, downsample_parity, quantize,
    )
    from raytracer_tpu_torch.pipeline import render_one_camera

    _, _, pdata, pmeta, pcs = shared_inputs("entry")
    _, cam = _cams("entry", cam_name)
    col = whitted.render_camera(pdata, pmeta, cam.scaled(ssaa) if ssaa > 1 else cam,
                                pcs, device="cpu")
    whole = (quantize(col) if ssaa == 1
             else downsample_parity(quantize(col), ssaa) if mode == "parity"
             else quantize(downsample_mean(col, ssaa))).numpy()
    one, _ = render_one_camera(pdata, pmeta, cam, pcs, ssaa=ssaa,
                               ssaa_mode=mode, device="cpu")
    np.testing.assert_array_equal(one, whole)
    bands = []
    call = whitted._Frame.__call__
    monkeypatch.setattr(whitted._Frame, "__call__", lambda self, *a:
                        bands.append(self.bh) or call(self, *a))
    img, _ = render_one_camera(pdata, pmeta, cam, pcs, ssaa=ssaa,
                               ssaa_mode=mode, chunk=_band_chunk(cam, ssaa),
                               device="cpu")
    assert len(bands) >= 2 and sum(bands) == cam.height * ssaa
    assert img.dtype == np.uint8 and img.shape == (cam.height, cam.width, 3)
    np.testing.assert_array_equal(img, whole)


def test_band_above_chunk_traced_in_chunks(monkeypatch):
    """A chunk below one lcm-aligned band (16 rows x 64 = 1,024 rays >
    1,000): the band is traced in wavefronts of at most the chunk (896
    rays, whole tiles), and the image is still the whole frame's."""
    from raytracer_tpu_torch.models import whitted
    from raytracer_tpu_torch.pipeline import render_one_camera

    _, _, pdata, pmeta, pcs = shared_inputs("entry")
    cam = pmeta.cameras[0]
    whole, _ = render_one_camera(pdata, pmeta, cam, pcs, device="cpu")
    sizes = []
    run = whitted._Wavefront.run
    monkeypatch.setattr(whitted._Wavefront, "run",
                        lambda self: sizes.append(self.r) or run(self))
    img, _ = render_one_camera(pdata, pmeta, cam, pcs, chunk=1000, device="cpu")
    assert max(sizes) == 896 and len(sizes) == 8
    np.testing.assert_array_equal(img, whole)


@pytest.mark.parametrize("scene,ssaa,mode", [
    ("entry", 1, "parity"), ("entry", 2, "parity"), ("entry", 2, "mean"),
    ("entry", 3, "parity"), ("terrain16", 2, "parity")])
def test_streamed_matches_jax(scene, ssaa, mode):
    jcam, pcam = _cams(scene, "64x64")
    chunk = _band_chunk(pcam, ssaa)
    j = _jax_streamed(scene, jcam, chunk=chunk, ssaa=ssaa, ssaa_mode=mode)
    p = _port_streamed(scene, pcam, chunk=chunk, ssaa=ssaa, ssaa_mode=mode)
    assert p.shape == j.shape == (64, 64, 3) and p.dtype == j.dtype == np.uint8
    assert p.max() > 0
    assert bad_pixels(p, j) <= 4


@pytest.mark.parametrize("ssaa_mode", ["mean", "jitter"])
def test_streamed_hdr_matches_jax(ssaa_mode):
    """The float path (EXR, tone curves): SSAA as a float mean per band."""
    jcam, pcam = _cams("entry", "24x20")
    kw = dict(chunk=_band_chunk(pcam, 2), ssaa=2, ssaa_mode=ssaa_mode, hdr=True,
              seed=3)
    j = _jax_streamed("entry", jcam, **kw)
    p = _port_streamed("entry", pcam, **kw)
    assert p.dtype == j.dtype == np.float32 and p.shape == j.shape == (20, 24, 3)
    assert np.isfinite(p).all()
    assert radiance_outside(p, j) <= 4


@pytest.mark.parametrize("scene,ssaa,seed", [("entry", 2, 0), ("entry", 3, 7),
                                             ("terrain16", 2, 1)])
def test_jitter_matches_jax(scene, ssaa, seed):
    """One seed, nothing injected: the port draws the JAX package's
    samples and gives its image at the image bars, over several bands."""
    jcam, pcam = _cams(scene, "64x64")
    kw = dict(chunk=_band_chunk(pcam, ssaa), ssaa=ssaa, ssaa_mode="jitter",
              seed=seed)
    j = _jax_streamed(scene, jcam, **kw)
    p = _port_streamed(scene, pcam, **kw)
    assert bad_pixels(p, j) <= 4
    # and the jitter does move samples: not the mean-mode image
    mean = _port_streamed(scene, pcam, chunk=kw["chunk"], ssaa=ssaa,
                          ssaa_mode="mean")
    assert (p != mean).any()


def test_jitter_seeded_draws():
    """The port's own draws (JAX's threefry keys, ``draw_jitter`` without
    injection): reproducible per (seed, key), independent across seeds,
    bands and streams, uniform in [-0.5, 0.5) on a 2**-23 grid; a seed
    outside [0, 2**32) raises on the band route (JAX's ``jnp.uint32``) and
    wraps mod 2**32 on the adaptive route (JAX's ``PRNGKey``); a frame
    renders the same under one seed and differently under another."""
    from raytracer_tpu_torch.ops.camera import draw_jitter

    def draw(seed, key, shape):
        return draw_jitter(None, seed, key, shape, "cpu")

    a = draw(5, ("band", 16), (16, 64, 2))
    assert a.dtype == torch.float32 and a.shape == (16, 64, 2)
    assert float(a.min()) >= -0.5 and float(a.max()) < 0.5
    assert torch.equal(a, draw(5, ("band", 16), (16, 64, 2)))
    for other in ((6, ("band", 16)), (5, ("band", 32)), (5, ("base", 16)),
                  (5, ("round", 0)), (5, ("round", 1))):
        assert not torch.equal(a, draw(*other, (16, 64, 2)))
    assert not torch.equal(draw(5, ("base", 0), (64, 2)),
                           draw(5, ("round", 0), (64, 2)))
    with pytest.raises(OverflowError, match="uint32"):
        draw(5 + 2**32, ("band", 16), (16, 64, 2))
    with pytest.raises(OverflowError, match="uint32"):
        draw(-1, ("band", 0), (16, 64, 2))
    assert torch.equal(draw(5 + 2**32, ("base", 0), (64, 2)),
                       draw(5, ("base", 0), (64, 2)))
    assert torch.equal(draw(-1, ("round", 2), (64, 2)),
                       draw(2**32 - 1, ("round", 2), (64, 2)))
    # uniform on a 2**-23 grid: mean 0, variance 1/12, neighbours and the
    # x/y pair uncorrelated (bounds of about 5 standard errors)
    big = draw(9, ("base", 0), (1 << 17, 2)).double()
    assert torch.equal(big * 2**23, torch.round(big * 2**23))
    assert abs(float(big.mean())) < 5e-3 and abs(float(big.var()) - 1 / 12) < 2e-3
    flat = big.flatten()
    for x, y in ((flat[:-1], flat[1:]), (big[:, 0], big[:, 1])):
        assert abs(float(torch.corrcoef(torch.stack([x, y]))[0, 1])) < 0.015
    _, pcam = _cams("entry", "24x20")
    kw = dict(chunk=_band_chunk(pcam, 2), ssaa=2, ssaa_mode="jitter")
    one = _port_streamed("entry", pcam, seed=1, **kw)
    np.testing.assert_array_equal(one, _port_streamed("entry", pcam, seed=1, **kw))
    assert (one != _port_streamed("entry", pcam, seed=2, **kw)).any()


def test_injected_jitter_shape_checked():
    with pytest.raises(ValueError, match="shape"):
        _port_streamed("entry", _cams("entry", "24x20")[1], ssaa=2,
                       ssaa_mode="jitter",
                       jitter=lambda key, shape: np.zeros((1, 1, 2), np.float32))


def test_eye_rays_band_equals_rows_of_frame():
    """A band without jitter is those rows of eye_rays_from, bit for bit;
    with jitter it equals the JAX package's eye_rays_band to 1 ulp-scale."""
    import jax.numpy as jnp

    from raytracer_tpu.ops.camera import eye_rays_band as jband
    from raytracer_tpu_torch.ops.camera import (
        camera_vectors, eye_rays_band, eye_rays_from,
    )

    pcam = shared_inputs("terrain16")[3].cameras[0]
    vec = torch.from_numpy(camera_vectors(pcam))
    w, h = 40, 36
    _, full = eye_rays_from(vec, w, h)
    for row0, bh in ((0, 16), (16, 16), (32, 4)):
        e, d = eye_rays_band(vec, w, h, row0, bh)
        assert torch.equal(d, full[row0 * w:(row0 + bh) * w])
        jit = np.random.default_rng(row0).uniform(-0.5, 0.5, (bh, w, 2)).astype(
            np.float32)
        _, dj = eye_rays_band(vec, w, h, row0, bh, jitter=torch.from_numpy(jit))
        _, jj = jband(jnp.asarray(vec.numpy()), w, h, row0, bh, jitter=jnp.asarray(jit))
        np.testing.assert_allclose(dj.numpy(), np.asarray(jj), rtol=1e-6, atol=1e-6)
