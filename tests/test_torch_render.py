"""The slice as a whole: the PyTorch port's CLI and ``render_camera`` on
the CPU (the plain kernel versions) against the JAX package's whole-frame
path on the same scenes."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_port_util import ENTRY_XML, jax_accel, shared_inputs


def _bad_pixels(a, b):
    d = np.abs(a.astype(int) - b.astype(int)).max(-1)
    return int((d > 1).sum())


@pytest.mark.parametrize("ssaa,mode", [(1, "parity"), (2, "parity"), (2, "mean")])
def test_cli_matches_jax(tmp_path, capsys, ssaa, mode):
    """The CLIs on entry_scene.xml (max depth 3, one light, one triangle,
    one small sphere, mirrors): at most 4 pixels differ by > 1 LSB."""
    from raytracer_tpu.render import main as jmain
    from raytracer_tpu_torch.render import main as pmain
    from raytracer_tpu_torch.utils.ppm import read_ppm

    args = [ENTRY_XML, "--ssaa", str(ssaa), "--ssaa-mode", mode]
    jmain(args + ["--mesh", "1", "--out-dir", str(tmp_path / "j")])
    capsys.readouterr()
    pmain(args + ["--device", "cpu", "--out-dir", str(tmp_path / "p")])
    out = capsys.readouterr().out
    for line in ("Planted trees in", "Rendering entry_scene.ppm", "Rendered in",
                 "Total:"):
        assert line in out
    j = read_ppm(str(tmp_path / "j" / "entry_scene.ppm"))
    p = read_ppm(str(tmp_path / "p" / "entry_scene.ppm"))
    assert p.shape == j.shape == (64, 64, 3)
    assert p.max() > 0
    assert _bad_pixels(p, j) <= 4


def _render_both(scene, ssaa):
    from raytracer_tpu.models.whitted import render_camera as jrender
    from raytracer_tpu_torch.models.whitted import render_camera

    jdata, jcs, pdata, pmeta, pcs = shared_inputs(scene)
    _, meta, _, _ = jax_accel(scene)
    cam = meta.cameras[0].scaled(ssaa) if ssaa > 1 else meta.cameras[0]
    jc = np.array(jrender(jdata, meta, cam, bvh=jcs))
    pcam = pmeta.cameras[0].scaled(ssaa) if ssaa > 1 else pmeta.cameras[0]
    pc = render_camera(pdata, pmeta, pcam, pcs, device="cpu").numpy()
    return jc, pc


def _quantized(c):
    from raytracer_tpu_torch.ops.image import quantize

    return quantize(torch.from_numpy(c)).numpy()


@pytest.mark.parametrize("scene,ssaa", [("entry", 1), ("entry", 2),
                                        ("terrain16", 1), ("terrain16d3", 1)])
def test_radiance_matches_jax(scene, ssaa, monkeypatch):
    """Whole frames: at most 4 pixels > 1 LSB after quantization, and
    radiance within rtol 1e-4 / atol 1e-3 on every other pixel (the JAX
    package's engine bars).  terrain16d3 (max depth 3) must take the
    activity compaction."""
    from raytracer_tpu_torch.models import whitted

    calls = []
    compact = whitted._compact_carry
    monkeypatch.setattr(whitted, "_compact_carry",
                        lambda c: calls.append(1) or compact(c))
    jc, pc = _render_both(scene, ssaa)
    assert pc.shape == jc.shape and np.isfinite(pc).all()
    if scene == "terrain16d3":
        assert calls, "the compaction gate never fired"
    assert _bad_pixels(_quantized(pc), _quantized(jc)) <= 4
    bad = ~np.isclose(pc, jc, rtol=1e-4, atol=1e-3).all(-1)
    assert bad.sum() <= 4, f"{bad.sum()} radiance pixels differ"


@pytest.mark.parametrize("scene", ["spheres600", "spheres1200"])
def test_sphere_field_radiance_matches_jax(scene):
    """Sphere fields at 64x64 (600 spheres: 5 clusters, the dense rows;
    1200: 10 clusters, the walk).  Hit primitives and shadow bits agree
    (test_torch_kernels, test_torch_shadow), but the JAX side's
    FMA-contracted sphere quadratic moves t in the last digits, and
    shading amplifies that on small spheres: a few pixels land > 1 LSB
    apart and 1-2% outside rtol 1e-4 / atol 1e-3.  Bars here: fewer than
    1% of pixels > 1 LSB (the JAX package's scene-sweep bar,
    tests/test_scenes_sweep.py) and at most 3% outside the radiance bar."""
    jc, pc = _render_both(scene, 1)
    n = jc.shape[0] * jc.shape[1]
    assert np.isfinite(pc).all()
    assert _bad_pixels(_quantized(pc), _quantized(jc)) < 0.01 * n
    bad = ~np.isclose(pc, jc, rtol=1e-4, atol=1e-3).all(-1)
    assert bad.sum() <= 0.03 * n


def _both_pipelines(seed=0, **kw):
    """render_one_camera of both packages on the entry scene's clusters:
    (port image, JAX image, port stats, JAX stats).  Nothing is injected:
    the port draws the JAX package's jitter itself (streamed bands and
    adaptive waves alike)."""
    from raytracer_tpu.pipeline import render_one_camera as jrender
    from raytracer_tpu_torch.pipeline import render_one_camera

    jdata, jcs, pdata, pmeta, pcs = shared_inputs("entry")
    _, meta, _, _ = jax_accel("entry")
    j, jstats = jrender(jdata, meta, meta.cameras[0], jcs, engine="cluster",
                        seed=seed, **kw)
    p, pstats = render_one_camera(pdata, pmeta, pmeta.cameras[0], pcs,
                                  seed=seed, device="cpu", **kw)
    return p, np.asarray(j), pstats, jstats


@pytest.mark.parametrize("ssaa,chunk", [(1, 1024), (2, 4096)])
def test_frame_beyond_chunk_raises(ssaa, chunk):
    """No longer raises: a frame above ``chunk`` rays (after SSAA) streams
    row bands through render_one_camera, as the JAX package's does, and
    the images agree at the image bar.  render_camera itself renders such
    a frame in chunks (test_torch_bigscene)."""
    p, j, pstats, jstats = _both_pipelines(ssaa=ssaa, chunk=chunk)
    assert p.shape == j.shape == (64, 64, 3) and p.dtype == np.uint8
    assert pstats is None and jstats is None
    assert _bad_pixels(p, j) <= 4


@pytest.mark.parametrize("mode", ["jitter", "adaptive"])
def test_unported_modes_raise(mode):
    """The modes that raised before this slice render through
    render_one_camera at --ssaa 2 and agree with the JAX package's at the
    image bar (the same seed, nothing injected); adaptive returns the same
    stats.  An
    unknown mode or tone still raises."""
    from raytracer_tpu_torch.pipeline import render_one_camera

    p, j, pstats, jstats = _both_pipelines(ssaa=2, ssaa_mode=mode)
    assert p.shape == j.shape == (64, 64, 3) and p.dtype == np.uint8
    assert pstats == jstats
    assert _bad_pixels(p, j) <= 4
    _, _, pdata, pmeta, pcs = shared_inputs("entry")
    for kw in (dict(ssaa_mode="stratified"), dict(tone="filmic")):
        with pytest.raises(ValueError, match="unknown"):
            render_one_camera(pdata, pmeta, pmeta.cameras[0], pcs, device="cpu",
                              **kw)


def test_pipeline_small_frame_matches_render_camera():
    """render_one_camera at ssaa 2 parity = quantize, then the truncating
    2x2 mean of render_camera's radiance."""
    from raytracer_tpu_torch.models.whitted import render_camera
    from raytracer_tpu_torch.ops.image import downsample_parity, quantize
    from raytracer_tpu_torch.pipeline import render_one_camera

    _, _, pdata, pmeta, pcs = shared_inputs("terrain16")
    cam = dataclasses.replace(pmeta.cameras[0], width=24, height=16)
    img, stats = render_one_camera(pdata, pmeta, cam, pcs, ssaa=2, device="cpu")
    assert stats is None
    col = render_camera(pdata, pmeta, cam.scaled(2), pcs, device="cpu")
    np.testing.assert_array_equal(img, downsample_parity(quantize(col), 2).numpy())
    assert img.shape == (16, 24, 3)


def test_per_light_shadow_launches_match_one_launch(monkeypatch):
    """Two lights whose plane tables fit the budget one at a time but not
    together take one shadow launch per light (cluster_shadow), as the JAX
    package does; the image is the same bit for bit."""
    from raytracer_tpu_torch.models.whitted import render_camera
    from raytracer_tpu_torch.ops import cluster_trace

    _, _, pdata, pmeta, pcs = shared_inputs("terrain16")
    assert pmeta.n_lights == 2
    cam = pmeta.cameras[0]
    one = render_camera(pdata, pmeta, cam, pcs, device="cpu")
    calls = []
    single = cluster_trace.cluster_shadow
    monkeypatch.setattr(cluster_trace, "SHADOW_PLANES_BYTES_MAX",
                        pcs.tri_dat.shape[1] * 64)
    monkeypatch.setattr(cluster_trace, "cluster_shadow",
                        lambda *a, **k: calls.append(1) or single(*a, **k))
    per_light = render_camera(pdata, pmeta, cam, pcs, device="cpu")
    assert calls
    assert torch.equal(per_light, one)
