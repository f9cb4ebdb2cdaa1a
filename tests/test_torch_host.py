"""Host-side structures of the PyTorch port equal the JAX package's: the
parsed XML, PPM bytes, every SceneData, BVH and ClusterSet field, eye
rays (at most 1 ulp), tile order and the image ops."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (
    ENTRY_XML, HOST_SCENES, assert_same, jax_accel, jax_scene, numpy_fields,
    port_scene,
)


def test_parse_xml_equal():
    from raytracer_tpu.utils.xml_ingest import parse_xml as jparse
    from raytracer_tpu_torch.utils.xml_ingest import parse_xml as pparse

    assert pparse(ENTRY_XML) == jparse(ENTRY_XML)


@pytest.mark.parametrize("native", [True, False])
def test_ppm_bytes_identical(tmp_path, monkeypatch, native):
    from raytracer_tpu.utils.ppm import write_ppm as jwrite
    from raytracer_tpu_torch.utils import native as pnative
    from raytracer_tpu_torch.utils.ppm import read_ppm, write_ppm

    if not native:  # the numpy loop the port takes without the library
        monkeypatch.setattr(pnative, "load", lambda: None)
    img = np.random.default_rng(3).integers(0, 256, (7, 11, 3), dtype=np.uint8)
    jwrite(str(tmp_path / "j.ppm"), img)
    write_ppm(str(tmp_path / "p.ppm"), img)
    assert (tmp_path / "p.ppm").read_bytes() == (tmp_path / "j.ppm").read_bytes()
    np.testing.assert_array_equal(read_ppm(str(tmp_path / "p.ppm")), img)


@pytest.mark.parametrize("scene", HOST_SCENES)
def test_scene_fields_equal(scene):
    jdata, jmeta = jax_scene(scene)
    pdata, pmeta = port_scene(scene)
    for name, val in numpy_fields(pdata).items():
        jv = np.asarray(getattr(jdata, name))
        assert val.dtype == jv.dtype, name
        assert_same(val, jv, name)
    assert dataclasses.asdict(pmeta) == dataclasses.asdict(jmeta)


@pytest.mark.parametrize("scene", HOST_SCENES)
def test_bvh_equal(scene):
    from raytracer_tpu_torch.models.bvh import build_bvh

    _, _, jbvh, _ = jax_accel(scene)
    pdata, pmeta = port_scene(scene)
    # the JAX build attaches the octant threads by default, the port's on
    # request (the bvh engine's)
    pbvh = build_bvh(pdata, pmeta, ordered=True)
    for name, val in numpy_fields(pbvh).items():
        assert_same(val, getattr(jbvh, name), name)


@pytest.mark.parametrize("scene", ["terrain16", "spheres1200"])
def test_bvh_numpy_fallback_equal(scene, monkeypatch):
    """The numpy build the port takes when the native library does not
    load gives the same tree as the JAX package's (native) build."""
    from raytracer_tpu_torch.models.bvh import build_bvh
    from raytracer_tpu_torch.utils import native as pnative

    monkeypatch.setattr(pnative, "load", lambda: None)
    _, _, jbvh, _ = jax_accel(scene)
    pbvh = build_bvh(*port_scene(scene))
    for name in ("prim_idx", "skip", "leaf_count", "leaf_start", "axis",
                 "box_min", "box_max"):
        assert_same(getattr(pbvh, name), getattr(jbvh, name), name)


@pytest.mark.parametrize("scene", HOST_SCENES)
def test_clusters_equal(scene):
    from raytracer_tpu_torch.models.bvh import build_bvh
    from raytracer_tpu_torch.models.clusters import build_clusters

    _, _, _, jcs = jax_accel(scene)
    pdata, pmeta = port_scene(scene)
    pcs = build_clusters(pdata, pmeta, build_bvh(pdata, pmeta))
    for name, val in numpy_fields(pcs).items():
        jv = getattr(jcs, name)
        if isinstance(val, int):
            assert val == jv, name
        else:
            assert val.dtype == np.asarray(jv).dtype, name
            assert_same(val, jv, name)
    if scene.startswith("terrain"):
        assert np.isnan(numpy_fields(pcs)["sph_cmin"]).all()  # no spheres


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("scene,w,h", [("entry", 64, 64), ("terrain16", 40, 24)])
def test_eye_rays_within_one_ulp(scene, w, h):
    from raytracer_tpu.ops.camera import camera_vectors as jvec
    from raytracer_tpu.ops.camera import eye_rays_from as jeye
    from raytracer_tpu_torch.ops.camera import camera_vectors, eye_rays_from

    jdata, jmeta = jax_scene(scene)
    cam = dataclasses.replace(jmeta.cameras[0], width=w, height=h)
    vec = np.asarray(jvec(cam))
    with jax.disable_jit():  # op by op, as PyTorch rounds
        jo, jd = jeye(jnp.asarray(vec), w, h)
    _, pmeta = port_scene(scene)
    pcam = dataclasses.replace(pmeta.cameras[0], width=w, height=h)
    pvec = camera_vectors(pcam)
    assert_same(pvec, vec, "camera vectors")
    po, pd = eye_rays_from(torch.from_numpy(pvec), w, h)
    assert_same(po.numpy(), jo, "origin")
    assert pd.shape == (w * h, 3)
    assert _ulps(pd.numpy(), jd).max() <= 1


@pytest.mark.parametrize("h,w", [(32, 48), (24, 40), (5, 7)])
def test_tile_order_equal(h, w):
    from raytracer_tpu.ops import tiling as jt
    from raytracer_tpu_torch.ops import tiling as pt

    x = np.random.default_rng(0).standard_normal((h * w, 3)).astype(np.float32)
    assert pt.divides(h, w, 8, 16) == jt.divides(h, w, 8, 16)
    jp, ji = jt.block_permutation(h, w, 8, 16)
    pp, pi = pt.block_permutation(h, w, 8, 16)
    assert_same(pp, jp, "perm")
    assert_same(pi, ji, "inv")
    blocks = (8, 16) if pt.divides(h, w, 8, 16) else None
    perm = None if blocks else torch.from_numpy(pp)
    inv = None if blocks else torch.from_numpy(pi)
    jy = jt.apply_tile_order(jnp.asarray(x), h, w, blocks,
                             None if blocks else jnp.asarray(jp))
    py = pt.apply_tile_order(torch.from_numpy(x), h, w, blocks, perm)
    assert_same(py.numpy(), jy, "tile order")
    back = pt.undo_tile_order(py, h, w, blocks, inv)
    assert_same(back.numpy(), x, "round trip")


def test_image_ops_equal():
    from raytracer_tpu.ops import image as ji
    from raytracer_tpu_torch.ops import image as pi

    rng = np.random.default_rng(5)
    color = rng.uniform(-20.0, 300.0, (8, 12, 3)).astype(np.float32)
    color[0, 0] = [254.5, 0.5, 255.49998]  # rounding edges
    jq = np.asarray(ji.quantize(jnp.asarray(color)))
    pq = pi.quantize(torch.from_numpy(color)).numpy()
    assert pq.dtype == np.uint8
    assert_same(pq, jq, "quantize")
    for f in (2, 4):
        assert_same(pi.downsample_parity(torch.from_numpy(pq), f).numpy(),
                    ji.downsample_parity(jnp.asarray(jq), f), "parity")
        with jax.disable_jit():
            jm = np.asarray(ji.downsample_mean(jnp.asarray(color), f))
        pm = pi.downsample_mean(torch.from_numpy(color), f).numpy()
        # float box means: the two frameworks may add the f*f samples in
        # another order, so 2 ulps of slack
        assert _ulps(pm, jm).max() <= 2
