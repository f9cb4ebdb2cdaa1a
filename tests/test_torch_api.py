"""The port's library surface against the JAX package's: the re-exported
names, the README snippet, ``camera_basis`` / ``eye_rays``, treelet
clusters, ``tile_cluster_mask`` with a t window and sub-intervals,
``--debug-nans`` and the inverse-rendering example, on the CPU."""

import dataclasses
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (
    ENTRY_XML, assert_same, bad_pixels, jax_accel, jax_scene, numpy_fields,
    port_meta, port_scene,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX package's names that the port spells its own way
RENAMED = {"ray_sharding": "shard_rays", "replicated": "replicate"}


@pytest.mark.parametrize("pkg", ["", ".ops", ".parallel"])
def test_public_names_resolve(pkg):
    """Every name the JAX package exports from the package, ``ops`` and
    ``parallel`` resolves in the port (``ray_sharding`` and ``replicated``
    under the port's names), without loading the kernel library."""
    import importlib

    from raytracer_tpu_torch import backend

    jmod = importlib.import_module("raytracer_tpu" + pkg)
    pmod = importlib.import_module("raytracer_tpu_torch" + pkg)
    want = {RENAMED.get(n, n) for n in jmod.__all__}
    assert want <= set(pmod.__all__)
    for name in pmod.__all__:
        assert callable(getattr(pmod, name)), name
    assert "lib" not in backend._state


def _readme_snippet():
    with open(os.path.join(REPO, "README.md")) as f:
        text = f.read()
    blocks = re.findall(r"```python\n(from raytracer_tpu_torch import .*?)```",
                        text, re.S)
    assert len(blocks) == 1
    return blocks[0]


def test_readme_snippet_runs():
    """The README's library snippet on the CPU and the entry scene: the JAX
    package's radiance at the image bar."""
    from raytracer_tpu.models.whitted import render_camera
    from raytracer_tpu_torch.ops.image import quantize

    code = _readme_snippet()
    assert 'device = "cuda"' in code and '"scene.xml"' in code
    env = {}
    exec(code.replace('device = "cuda"', 'device = "cpu"')
         .replace('"scene.xml"', repr(ENTRY_XML)), env)
    img = env["image"]
    assert img.shape == (64, 64, 3) and bool(torch.isfinite(img).all())
    data, meta, _, cs = jax_accel("entry")
    want = render_camera(data, meta, meta.cameras[0], bvh=cs, engine="cluster")
    q = quantize(torch.from_numpy(np.array(want))).numpy()
    assert bad_pixels(quantize(img).numpy(), q) <= 4


@pytest.mark.parametrize("scene", ["entry", "terrain16"])
def test_camera_basis_and_eye_rays_match_jax(scene):
    """Op-for-op camera arithmetic: equal to the eager JAX functions."""
    from raytracer_tpu.ops.camera import camera_basis as jbasis
    from raytracer_tpu.ops.camera import eye_rays as jrays
    from raytracer_tpu_torch.ops import eye_rays
    from raytracer_tpu_torch.ops.camera import camera_basis

    jcam = jax_scene(scene)[1].cameras[0]
    pcam = port_meta(jax_scene(scene)[1]).cameras[0]
    with jax.disable_jit():
        jb, (jo, jd) = jbasis(jcam), jrays(jcam)
    for i, (a, b) in enumerate(zip(camera_basis(pcam, device="cpu"), jb)):
        assert_same(a.numpy(), b, f"basis {i}")
    po, pd = eye_rays(pcam, device="cpu")
    assert_same(po.numpy(), jo, "origin")
    assert_same(pd.numpy(), jd, "dirs")
    assert pd.shape == (pcam.width * pcam.height, 3)


def _mixed_parsed():
    """A scene whose BVH leaves mix triangles and spheres: a 12x12-cell
    terrain with 200 spheres resting on it (treelet ranges then hold
    spheres, which leave padded gaps among the triangle slots)."""
    rng = np.random.default_rng(4)
    n, ext = 13, 40.0
    xs = np.linspace(-ext / 2, ext / 2, n)
    xg, zg = np.meshgrid(xs, xs, indexing="ij")
    y = 2.0 * np.sin(xg / 5.0) * np.cos(zg / 6.0) + rng.normal(0, 0.1, xg.shape)
    verts = [np.stack([xg, y, zg], -1).reshape(-1, 3)]
    a = (np.arange(n - 1)[:, None] * n + np.arange(n - 1)[None, :]).ravel() + 1
    faces = [(int(p), int(p + 1), int(p + n)) for p in a]
    faces += [(int(p + 1), int(p + n + 1), int(p + n)) for p in a]
    m = 200
    c = np.stack([rng.uniform(-ext / 2, ext / 2, m), rng.uniform(1.0, 4.0, m),
                  rng.uniform(-ext / 2, ext / 2, m)], 1)
    verts.append(c)
    mat = dict(is_mirror=False, ambient=[0.1] * 3, diffuse=[0.6, 0.5, 0.4],
               specular=[0.3] * 3, mirror=[0.0] * 3, phong=20.0)
    mirror = dict(mat, is_mirror=True, mirror=[0.6] * 3)
    return {
        "background": [20, 30, 60], "shadow_eps": 1e-3, "max_depth": 2,
        "cameras": [{"position": [0.0, 25.0, 35.0], "gaze": [0.0, -0.6, -1.0],
                     "up": [0.0, 1.0, 0.0], "near_plane": [-1.0, 1.0, -1.0, 1.0],
                     "near_distance": 1.0, "width": 64, "height": 64,
                     "image_name": "mixed.ppm"}],
        "ambient_light": [40.0] * 3,
        "point_lights": [([0.0, 50.0, 0.0], [2.5e5] * 3),
                         ([20.0, 30.0, 20.0], [1.0e5] * 3)],
        "materials": [mat, mirror],
        "vertices": np.concatenate(verts).ravel().tolist(),
        "meshes": [(1, faces)], "triangles": [],
        "spheres": [(2 if i % 5 == 0 else 1, n * n + i + 1,
                     float(rng.uniform(0.5, 1.5))) for i in range(m)],
    }


def _scenes(name):
    """(JAX data, meta), (port data, meta) of a treelet test scene."""
    if name == "mixed":
        from raytracer_tpu.models.scene import from_parsed as jparsed
        from raytracer_tpu_torch.models.scene import from_parsed

        return jparsed(_mixed_parsed()), from_parsed(_mixed_parsed(), "cpu")
    return jax_scene(name), port_scene(name)


TREELET_SCENES = ["entry", "terrain16", "spheres600", "mixed"]


@pytest.mark.parametrize("scene", TREELET_SCENES)
def test_treelet_clusters_equal_jax(scene):
    """build_clusters(..., treelet=True): every array equal to the JAX
    build's (each package on its own BVH); on the mixed scene the triangle
    slots have gaps and more clusters than the contiguous layout."""
    from raytracer_tpu.models.bvh import build_bvh as jbvh
    from raytracer_tpu.models.clusters import build_clusters as jbuild
    from raytracer_tpu_torch import build_bvh, build_clusters

    (jd, jm), (pd, pm) = _scenes(scene)
    want = numpy_fields(jbuild(jd, jm, jbvh(jd, jm), treelet=True))
    got = numpy_fields(build_clusters(pd, pm, build_bvh(pd, pm), treelet=True))
    assert want.keys() == got.keys()
    for k in want:
        assert_same(got[k], want[k], k)
    if scene == "mixed":
        flat = build_clusters(pd, pm, build_bvh(pd, pm))
        valid = (got["tri_verts"] != 0).any(0)
        assert valid.sum() == pm.n_tris and not valid[:pm.n_tris].all()
        assert got["tri_dat"].shape[1] > flat.tri_dat.shape[1]


@pytest.mark.parametrize("scene", ["terrain16", "spheres600", "mixed"])
def test_treelet_render_matches_jax(scene):
    """A whole frame on the treelet clusters (the JAX build handed to the
    port): the JAX package's image at the image bars, and the port's own
    treelet build renders the same image."""
    from raytracer_tpu.models.bvh import build_bvh as jbvh
    from raytracer_tpu.models.clusters import build_clusters as jbuild
    from raytracer_tpu.models.whitted import render_camera as jrender
    from raytracer_tpu_torch import build_bvh, build_clusters, render_camera
    from raytracer_tpu_torch.convert import clusters_from_numpy
    from raytracer_tpu_torch.ops.image import quantize

    (jd, jm), (pd, pm) = _scenes(scene)
    jcs = jbuild(jd, jm, jbvh(jd, jm), treelet=True)
    cam = dataclasses.replace(pm.cameras[0], width=64, height=64)
    jcam = dataclasses.replace(jm.cameras[0], width=64, height=64)
    want = quantize(torch.from_numpy(np.asarray(jrender(
        jax.device_put(jd), jm, jcam, bvh=jax.device_put(jcs),
        engine="cluster")))).numpy()
    got = render_camera(pd, pm, cam, clusters_from_numpy(numpy_fields(jcs), "cpu"),
                        device="cpu")
    n_bad = bad_pixels(quantize(got).numpy(), want)
    assert n_bad <= 4 and n_bad < 0.01 * 64 * 64, n_bad
    own = render_camera(pd, pm, cam, build_clusters(pd, pm, build_bvh(pd, pm),
                                                    treelet=True), device="cpu")
    assert torch.equal(own, got)


@pytest.mark.parametrize("t_hi,subsplit", [(True, 1), (False, 2), (False, 4),
                                           (True, 2), (True, 4)])
@pytest.mark.parametrize("shared", [True, False])
def test_tile_cluster_mask_window_and_subsplit_equal_jax(t_hi, subsplit, shared):
    """The interval tile mask with a per-ray t window, with sub-intervals,
    and with both, on coherent tiles of the 64-cluster terrain (its eye
    rays in tile order, or segments from points along them toward a
    light), 10% of the lanes and two whole tiles inactive: JAX's eager
    result bit for bit, within the mask without them, and tighter."""
    from raytracer_tpu.ops import cluster_trace as jct
    from raytracer_tpu_torch.ops import cluster_trace as pct
    from raytracer_tpu_torch.ops.camera import eye_rays
    from raytracer_tpu_torch.ops.tiling import apply_tile_order

    _, meta, _, cs = jax_accel("terrain64")
    cam = dataclasses.replace(port_meta(meta).cameras[0], width=32, height=64)
    e, d = eye_rays(cam, device="cpu")
    d = apply_tile_order(d, 64, 32, (8, 16), None).numpy()
    rng = np.random.default_rng(5)
    if shared:
        o = np.broadcast_to(e.numpy(), d.shape).copy()
        th = rng.uniform(20.0, 90.0, d.shape[0])
    else:
        o = e.numpy() + d * rng.uniform(20.0, 80.0, (d.shape[0], 1)).astype(np.float32)
        d = np.array([0.0, 60.0, 0.0], np.float32) - o
        th = rng.uniform(0.05, 1.0, d.shape[0])
    th = th.astype(np.float32) if t_hi else None
    act = rng.random(d.shape[0]) < 0.9
    act[:256] = False
    cmin = np.concatenate([np.asarray(cs.tri_cmin), np.asarray(cs.sph_cmin)])
    cmax = np.concatenate([np.asarray(cs.tri_cmax), np.asarray(cs.sph_cmax)])
    args = (o, d, act, cmin, cmax)
    with jax.disable_jit():
        jh, je = jct.tile_cluster_mask(
            *map(jnp.asarray, args), None if th is None else jnp.asarray(th),
            128, subsplit=subsplit)
    ph, pe = pct.tile_cluster_mask(
        *map(torch.from_numpy, args), None if th is None else torch.from_numpy(th),
        128, subsplit=subsplit)
    assert_same(ph.numpy(), jh, "hit")
    assert_same(pe.numpy(), je, "entry")
    assert ph.shape == (16, cmin.shape[0]) and not ph[:2].any()
    loose, _ = pct.tile_cluster_mask(*map(torch.from_numpy, args), None, 128)
    assert bool((ph <= loose).all())
    if subsplit == 4 or (t_hi and shared):
        assert int(ph.sum()) < int(loose.sum())


def _nan_scene_xml(tmp_path):
    """The entry scene with the triangle's diffuse reflectance NaN."""
    with open(ENTRY_XML) as f:
        text = f.read()
    text = text.replace("<DiffuseReflectance>0.8 0.4 0.2</DiffuseReflectance>",
                        "<DiffuseReflectance>nan 0.4 0.2</DiffuseReflectance>", 1)
    path = tmp_path / "nan_scene.xml"
    path.write_text(text)
    return str(path)


def test_debug_nans(tmp_path, capsys):
    """--debug-nans: the entry scene renders the image of a run without the
    flag; a NaN diffuse reflectance raises FloatingPointError naming the
    band and the bounce, where the run without the flag writes an image.
    ``debug_nans`` turns autograd's anomaly mode on for its block."""
    from raytracer_tpu_torch.models.whitted import debug_nans
    from raytracer_tpu_torch.render import main
    from raytracer_tpu_torch.utils.ppm import read_ppm

    out = {}
    for flag in ((), ("--debug-nans",)):
        d = tmp_path / f"out{len(flag)}"
        main([ENTRY_XML, "--ssaa", "2", "--device", "cpu", "--out-dir", str(d),
              *flag])
        out[flag] = read_ppm(str(d / "entry_scene.ppm"))
    np.testing.assert_array_equal(out[()], out[("--debug-nans",)])
    bad = _nan_scene_xml(tmp_path)
    main([bad, "--ssaa", "1", "--device", "cpu", "--out-dir", str(tmp_path / "n")])
    with pytest.raises(FloatingPointError,
                       match=r"band of rows 0-63: radiance not finite after bounce 0"):
        main([bad, "--ssaa", "1", "--device", "cpu", "--debug-nans",
              "--out-dir", str(tmp_path / "m")])
    with pytest.raises(FloatingPointError, match=r"adaptive base wave 0: .*bounce 0"):
        main([bad, "--ssaa-mode", "adaptive", "--device", "cpu", "--debug-nans",
              "--out-dir", str(tmp_path / "a")])
    assert not torch.is_anomaly_enabled()
    with debug_nans():
        assert torch.is_anomaly_enabled()
    assert not torch.is_anomaly_enabled()


def test_debug_nans_differentiable():
    """The differentiable path under debug_nans: a NaN albedo raises at the
    bounce that first shades it."""
    from raytracer_tpu_torch import render_rays
    from raytracer_tpu_torch.models.whitted import debug_nans
    from raytracer_tpu_torch.ops import eye_rays

    data, meta = port_scene("entry")
    data = dataclasses.replace(
        data, mat_diffuse=data.mat_diffuse.clone().requires_grad_(True))
    origin, dirs = eye_rays(dataclasses.replace(meta.cameras[0], width=16,
                                                height=16), device="cpu")
    with debug_nans():
        loss = render_rays(data, meta, origin, dirs, None, engine="brute",
                           differentiable=True).sum()
        loss.backward()
    assert bool(torch.isfinite(data.mat_diffuse.grad).all())
    bad = dataclasses.replace(data, mat_diffuse=data.mat_diffuse.detach() * np.nan)
    with debug_nans(), pytest.raises(FloatingPointError, match="bounce 0"):
        render_rays(bad, meta, origin, dirs, None, engine="brute",
                    differentiable=True)


def test_inverse_rendering_example_lowers_loss(capsys):
    """examples/inverse_rendering_torch.py's main at 3 steps on the CPU:
    the loss falls at every step; the printout names the albedos."""
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        from inverse_rendering_torch import main
    finally:
        sys.path.pop(0)
    losses = main(ENTRY_XML, "cluster", steps=3, device="cpu")
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert losses[0] > losses[1] > losses[2]
    out = capsys.readouterr().out
    assert "step    0  loss" in out and "recovered   :" in out
