"""The brute and BVH engines of the port (``ops/intersect.py``,
``ops/traverse.py``, ``models/bvh.py``) against the JAX package's, on the
CPU, and the port's three engines against each other.

Bars: the intersection functions equal eager ``jnp`` bit for bit; host
builds (the octant threads) are equal; primitive ids and occlusion bits
are equal except on float32-ambiguous lanes (a triangle edge, a grazing
sphere, an exact t tie, a t at the segment's end), which XLA's FMA
contraction inside the JAX engines' compiled loops may flip; rendered
images meet the image bar (at most 4 pixels > 1 LSB).
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_port_util import (
    ENTRY_XML, assert_same, bad_pixels, float32_ambiguous, jax_accel,
    numpy_fields, port_scene, prim_slots, scene_rays, shared_inputs, _pair64,
)

SCENES = ["entry", "terrain16", "spheres600"]


def _rand_geometry(n, seed):
    """Random rays and primitives with the degenerate corners mixed in:
    collapsed triangles, axis-parallel directions (0 * inf in the slab
    test), origins inside spheres and boxes."""
    rng = np.random.default_rng(seed)
    f = np.float32
    o = rng.normal(0, 2, (n, 3)).astype(f)
    a = rng.normal(0, 2, (n, 3)).astype(f)
    b = rng.normal(0, 2, (n, 3)).astype(f)
    c = rng.normal(0, 2, (n, 3)).astype(f)
    # toward the triangle's centroid, off by up to about its size
    d = ((a + b + c) / 3 - o + rng.normal(0, 0.7, (n, 3))).astype(f)
    d[::7, 0] = 0.0                           # zero direction components
    d[::11, 1:] = 0.0
    b[::5] = a[::5]                           # degenerate: an edge of 0
    c[::9] = a[::9] + 2 * (b[::9] - a[::9])   # degenerate: collinear
    center = rng.normal(0, 2, (n, 3)).astype(f)
    rad = rng.uniform(0.1, 3, n).astype(f)
    center[::4] = o[::4]                      # origin inside the sphere
    bmin = np.minimum(a, b) - 0.5
    bmax = np.maximum(a, b) + 0.5
    bmin[::6, 0] = o[::6, 0]                  # origin on a slab plane
    bmin[::8] = o[::8] - 1.0                  # origin inside the box
    bmax[::8] = o[::8] + 1.0
    return o, d, a, b, c, center, rad, bmin, bmax


@pytest.mark.parametrize("bfc", [False, True])
def test_intersections_equal_eager_jnp(bfc):
    """tri_intersect, sphere_intersect and aabb_intersect equal eager jnp
    bit for bit (t, NaN included, and the acceptance bits; the sphere t
    wherever the two libraries' square roots agree)."""
    import jax.numpy as jnp

    from raytracer_tpu.ops import intersect as J
    from raytracer_tpu_torch.ops import intersect as P

    o, d, a, b, c, center, rad, bmin, bmax = _rand_geometry(4096, 1)
    T = torch.from_numpy
    with np.errstate(all="ignore"):
        inv = (1.0 / d).astype(np.float32)
    jt, jok = J.tri_intersect(*map(jnp.asarray, (o, d, a, b, c)), bfc=bfc)
    pt, pok = P.tri_intersect(*map(T, (o, d, a, b, c)), bfc=bfc)
    assert_same(pt, jt, "triangle t")
    assert_same(pok, jok, "triangle hit")
    assert 0.05 < float(pok.float().mean()) < 0.95
    jt, jok = J.sphere_intersect(*map(jnp.asarray, (o, d, center, rad)))
    pt, pok = P.sphere_intersect(*map(T, (o, d, center, rad)))
    # PyTorch's vectorized CPU sqrt is not correctly rounded (1 ulp off on
    # ~0.6% of inputs on AVX-512), XLA's is: t is equal wherever the two
    # square roots of the (bit-equal) discriminant agree, within 2 ulp
    # elsewhere
    oc = T(o) - T(center)
    disc = ((2.0 * P.dot(T(d), oc)) ** 2
            - 4.0 * P.dot(T(d), T(d)) * (P.dot(oc, oc) - T(rad) * T(rad)))
    disc = torch.clamp_min(disc, 0.0).numpy()
    same_sqrt = np.asarray(jnp.sqrt(disc)) == torch.sqrt(T(disc)).numpy()
    assert same_sqrt.mean() > 0.99
    assert_same(pt.numpy()[same_sqrt], np.asarray(jt)[same_sqrt], "sphere t")
    np.testing.assert_array_max_ulp(pt.numpy()[pok.numpy()],
                                    np.asarray(jt)[pok.numpy()], maxulp=2)
    assert_same(pok, jok, "sphere hit")
    assert bool((pok & (pt < 0)).any()), "no origin-inside hit"
    jt, jok = J.aabb_intersect(*map(jnp.asarray, (o, inv, bmin, bmax)))
    pt, pok = P.aabb_intersect(*map(T, (o, inv, bmin, bmax)))
    assert_same(pt, jt, "slab tmin")
    assert_same(pok, jok, "slab hit")
    assert bool(torch.isnan((T(bmin) - T(o)) * T(inv)).any()), "no 0 * inf"


def _scene_np(data):
    """The scene's primitives as float64 numpy: (tri a, b, c, tri valid,
    sphere centers, radii, sphere valid)."""
    f = numpy_fields(data)
    v = f["vertices"].astype(np.float64)
    tv = f["tri_v"].astype(np.int64)
    return (v[tv[:, 0]], v[tv[:, 1]], v[tv[:, 2]], f["tri_valid"],
            v[f["sphere_cvid"].astype(np.int64)],
            f["sphere_rad"].astype(np.float64), f["sphere_valid"])


def _all_pairs64(data, origin, dirs):
    """(t, margin) (R, P) of every ray against every primitive slot (prim
    id order: triangles, then spheres) in float64; margin: the least
    barycentric (triangles) or the discriminant over b^2 (spheres), NaN
    for padding slots."""
    a, b, c, tvalid, cen, rad, svalid = _scene_np(data)
    o = np.asarray(origin, np.float64)[:, None]
    d = np.asarray(dirs, np.float64)[:, None]
    e1, e2 = b - a, c - a
    pvec = np.cross(d, e2[None])
    det = (pvec * e1[None]).sum(-1)
    with np.errstate(all="ignore"):
        tvec = o - a[None]
        u = (tvec * pvec).sum(-1) / det
        qvec = np.cross(tvec, e1[None])
        v = (d * qvec).sum(-1) / det
        t_tri = (e2[None] * qvec).sum(-1) / det
        m_tri = np.minimum(np.minimum(u, v), 1 - u - v)
        oc = o - cen[None]
        qa = (d * d).sum(-1)
        qb = 2 * (d * oc).sum(-1)
        qc = (oc * oc).sum(-1) - rad[None] ** 2
        disc = qb * qb - 4 * qa * qc
        t_sph = (-qb - np.sqrt(np.maximum(disc, 0))) / (2 * qa)
        m_sph = disc / (qb * qb)
    t = np.concatenate([t_tri, t_sph], 1)
    m = np.concatenate([np.where(tvalid[None], m_tri, np.nan),
                        np.where(svalid[None], m_sph, np.nan)], 1)
    return t, m


def _closest_ambiguous(cs, origin, dirs, pa, pb):
    """Lanes where two closest-hit prim ids may rightly differ
    (``float32_ambiguous`` on their slots)."""
    sa, sb = prim_slots(cs, pa), prim_slots(cs, pb)
    ta = _pair64(cs, origin, dirs, sa)[0]
    tb = _pair64(cs, origin, dirs, sb)[0]
    return float32_ambiguous(cs, origin, dirs, sa, sb, ta, tb)


def assert_prims_agree(cs, origin, dirs, pa, pb, what):
    pa, pb = np.asarray(pa), np.asarray(pb)
    differ = pa != pb
    amb = _closest_ambiguous(cs, origin, dirs, pa, pb)
    assert not (differ & ~amb).any(), (
        f"{what}: {int((differ & ~amb).sum())} lanes differ outside the "
        f"tie class (of {pa.size})")
    assert differ.mean() < 0.01, f"{what}: {int(differ.sum())} lanes differ"


def assert_occlusion_agrees(data, origin, dirs, t_max, oa, ob, what,
                            edge=1e-4, rel=1e-4):
    """Occlusion bits equal but on lanes where some primitive's hit is
    float32-ambiguous: on an edge or grazing, or at t 0 or t_max."""
    oa, ob = np.asarray(oa), np.asarray(ob)
    differ = oa != ob
    if differ.any():
        t, m = _all_pairs64(data, origin[differ], dirs[differ])
        tm = np.asarray(t_max, np.float64)[differ][:, None]
        near = (np.abs(m) < edge) & (t > -rel) & (t < tm * (1 + rel))
        near |= (np.abs(t - tm) <= rel * tm) | (np.abs(t) <= rel)
        bad = int((~near.any(1)).sum())
        assert bad == 0, f"{what}: {bad} lanes differ outside the tie class"
    assert differ.mean() < 0.01, f"{what}: {int(differ.sum())} lanes differ"


def _rays(name, n=2048, seed=5):
    """(origin, dirs, t_max) numpy: random rays into the scene, and segment
    ends before, inside and beyond the geometry."""
    _, meta, _, cs = jax_accel(name)
    origin, dirs, _ = scene_rays(cs, n, seed)
    t_max = np.random.default_rng(seed).uniform(0.2, 1.5, n).astype(np.float32)
    return origin, dirs, t_max


@pytest.mark.parametrize("name", SCENES)
def test_brute_engine_matches_jax(name):
    import jax.numpy as jnp

    from raytracer_tpu.ops import traverse as JT
    from raytracer_tpu_torch.ops import traverse as PT

    jdata, _, pdata, _, _ = shared_inputs(name)
    _, _, _, cs = jax_accel(name)
    origin, dirs, t_max = _rays(name)
    jp = np.asarray(JT.brute_closest(jdata, jnp.asarray(origin),
                                     jnp.asarray(dirs)))
    pp = PT.brute_closest(pdata, torch.from_numpy(origin),
                          torch.from_numpy(dirs))
    assert pp.dtype == torch.int64 and (pp >= 0).float().mean() > 0.2
    assert_prims_agree(cs, origin, dirs, pp.numpy(), jp, f"{name} brute_closest")
    jo = np.asarray(JT.brute_any(jdata, jnp.asarray(origin), jnp.asarray(dirs),
                                 jnp.asarray(t_max)))
    po = PT.brute_any(pdata, torch.from_numpy(origin), torch.from_numpy(dirs),
                      torch.from_numpy(t_max)).numpy()
    assert 0.05 < po.mean() < 0.95
    assert_occlusion_agrees(pdata, origin, dirs, t_max, po, jo,
                            f"{name} brute_any")


def test_brute_chunks_overlap_and_keep_lowest_id():
    """The last primitive chunk is clamped (overlaps the one before) and an
    exact t tie keeps the lower id: a triangle before a sphere, the first
    of two duplicated triangles."""
    from raytracer_tpu_torch.ops import traverse as PT

    assert PT._chunk_starts(1100, 512) == ([0, 512, 588], 512)
    assert PT._chunk_starts(100, 512) == ([0], 100)
    assert PT._chunk_starts(0, 512) == (None, 0)
    data, meta = port_scene("entry")
    # every triangle slot a copy of triangle 0: the closest hit is slot 0
    n = data.tri_v.shape[0]
    dup = dataclasses.replace(
        data, tri_v=data.tri_v[:1].expand(n, 3).contiguous(),
        tri_valid=torch.ones(n, dtype=torch.bool))
    origin = torch.tensor([0.0, 0.0, 0.0])
    dirs = torch.tensor([[0.0, -1.0, -4.0], [0.0, -1.0, -8.0]])
    for chunk in (1, 3, 512):
        p = PT.brute_closest(dup, origin, dirs, chunk=chunk)
        assert p.tolist() == [0, 0], chunk


@pytest.mark.parametrize("name", SCENES)
def test_bvh_octant_threads_match_jax(name):
    """The octant threads equal the JAX build's (built by default there,
    only on request here); validate_bvh accepts the port's builds and
    rejects a corrupted skip pointer."""
    from raytracer_tpu_torch.models.bvh import (
        OCT_FIELDS, build_bvh, device_bvh, validate_bvh, with_octant_threads,
    )

    _, meta, jbvh, _ = jax_accel(name)
    data, pmeta = port_scene(name)
    plain = build_bvh(data, pmeta)
    assert plain.oct_skip is None
    bvh = build_bvh(data, pmeta, ordered=True)
    assert with_octant_threads(bvh) is bvh
    for f in dataclasses.fields(bvh):
        np.testing.assert_array_equal(getattr(bvh, f.name),
                                      np.asarray(getattr(jbvh, f.name)),
                                      err_msg=f.name)
    n = meta.n_tris + meta.n_spheres
    validate_bvh(bvh, n)
    dev = device_bvh(bvh, "cpu")
    assert (dev.blocks, dev.n_nodes) == (8, bvh.skip.shape[0])
    for f in OCT_FIELDS:
        got = getattr(dev, f[len("oct_"):])
        assert got.device == torch.device("cpu")
        np.testing.assert_array_equal(got.numpy(), getattr(bvh, f), f)
    assert device_bvh(plain, "cpu").blocks == 1
    skip = bvh.skip.copy()
    skip[0] = 0
    with pytest.raises(AssertionError):
        validate_bvh(dataclasses.replace(bvh, skip=skip), n)


@pytest.mark.parametrize("name", SCENES)
def test_bvh_engine_matches_jax(name, monkeypatch):
    """bvh_closest / bvh_any through the octant threads against the JAX
    walk (which takes them off the TPU); the same results with the loop
    condition tested every iteration, and through the plain preorder."""
    import jax
    import jax.numpy as jnp

    from raytracer_tpu.ops import traverse as JT
    from raytracer_tpu_torch.models.bvh import build_bvh, device_bvh
    from raytracer_tpu_torch.ops import traverse as PT

    jdata, _, pdata, pmeta, _ = shared_inputs(name)
    _, _, jbvh, cs = jax_accel(name)
    assert jbvh.oct_skip is not None
    origin, dirs, t_max = _rays(name, seed=6)
    o, d, tm = map(torch.from_numpy, (origin, dirs, t_max))
    bvh = device_bvh(build_bvh(pdata, pmeta, ordered=True), "cpu")
    jb = jax.device_put(jbvh)
    jp = np.asarray(JT.bvh_closest(jdata, jb, jnp.asarray(origin),
                                   jnp.asarray(dirs)))
    pp = PT.bvh_closest(pdata, bvh, o, d).numpy()
    assert (pp >= 0).mean() > 0.2
    assert_prims_agree(cs, origin, dirs, pp, jp, f"{name} bvh_closest")
    jo = np.asarray(JT.bvh_any(jdata, jb, jnp.asarray(origin),
                               jnp.asarray(dirs), jnp.asarray(t_max)))
    po = PT.bvh_any(pdata, bvh, o, d, tm).numpy()
    assert_occlusion_agrees(pdata, origin, dirs, t_max, po, jo,
                            f"{name} bvh_any")
    monkeypatch.setattr(PT, "_WALK_CHECK", 1)
    assert_same(PT.bvh_closest(pdata, bvh, o, d), pp, "every-iteration check")
    assert_same(PT.bvh_any(pdata, bvh, o, d, tm), po, "every-iteration check")
    plain = device_bvh(build_bvh(pdata, pmeta), "cpu")
    assert_prims_agree(cs, origin, dirs, PT.bvh_closest(pdata, plain, o, d),
                       pp, f"{name} plain preorder walk")


@pytest.mark.parametrize("name", SCENES)
def test_port_engines_agree(name):
    """brute, bvh and cluster closest hits and occlusion inside the port,
    on random rays with 90% of them active."""
    from raytracer_tpu_torch.models.bvh import build_bvh, device_bvh
    from raytracer_tpu_torch.ops import traverse as PT

    _, _, pdata, pmeta, pcs = shared_inputs(name)
    _, _, _, cs = jax_accel(name)
    origin, dirs, active = scene_rays(cs, 2048, 7)
    t_max = np.ones(len(dirs), np.float32)
    o, d, a, tm = map(torch.from_numpy, (origin, dirs, active, t_max))
    accels = {"brute": None,
              "bvh": device_bvh(build_bvh(pdata, pmeta, ordered=True), "cpu"),
              "cluster": pcs}
    prims = {e: PT.closest_hit(pdata, o, d, acc, e, active=a).numpy()
             for e, acc in accels.items()}
    occ = {e: PT.any_hit(pdata, o, d, tm, acc, e, active=a).numpy()
           for e, acc in accels.items()}
    for e in ("bvh", "cluster"):
        assert_prims_agree(cs, origin[active], dirs[active],
                           prims[e][active], prims["brute"][active],
                           f"{name} {e} vs brute")
        assert_occlusion_agrees(pdata, origin[active], dirs[active],
                                t_max[active], occ[e][active],
                                occ["brute"][active], f"{name} {e} vs brute")
    with pytest.raises(ValueError, match="unknown engine"):
        PT.closest_hit(pdata, o, d, None, "nope")


@pytest.mark.parametrize("engine", ["brute", "bvh", "auto"])
def test_cli_engines_match_jax(tmp_path, capsys, engine):
    """The CLIs with --engine on entry_scene.xml at --ssaa 2: the image
    bar, and the engine named in the port's output (auto: cluster)."""
    from raytracer_tpu.render import main as jmain
    from raytracer_tpu_torch.render import main as pmain
    from raytracer_tpu_torch.utils.ppm import read_ppm

    args = [ENTRY_XML, "--ssaa", "2", "--engine", engine]
    jmain(args + ["--mesh", "1", "--out-dir", str(tmp_path / "j")])
    capsys.readouterr()
    pmain(args + ["--device", "cpu", "--out-dir", str(tmp_path / "p")])
    out = capsys.readouterr().out
    named = "cluster" if engine == "auto" else engine
    assert f"engine={named}" in out
    j = read_ppm(str(tmp_path / "j" / "entry_scene.ppm"))
    p = read_ppm(str(tmp_path / "p" / "entry_scene.ppm"))
    assert p.shape == j.shape == (64, 64, 3) and p.max() > 0
    assert bad_pixels(p, j) <= 4


@pytest.mark.parametrize("engine", ["brute", "bvh"])
def test_render_camera_engines_match_cluster(engine):
    """render_camera through brute or bvh (raster order, no kernels) and
    through the cluster engine (tile order, the kernels): the image bar on
    the mirror terrain at 48x48, and the auto rule picks bvh for a BVH."""
    from raytracer_tpu_torch.models.bvh import build_bvh, device_bvh
    from raytracer_tpu_torch.models.whitted import render_camera, resolve_engine
    from raytracer_tpu_torch.ops.image import quantize

    _, _, pdata, pmeta, pcs = shared_inputs("terrain16")
    cam = dataclasses.replace(pmeta.cameras[0], width=48, height=48)
    accel = (device_bvh(build_bvh(pdata, pmeta, ordered=True), "cpu")
             if engine == "bvh" else None)
    assert resolve_engine("auto", accel, pmeta) == engine
    img = quantize(render_camera(pdata, pmeta, cam, accel, device="cpu",
                                 engine=engine)).numpy()
    ref = quantize(render_camera(pdata, pmeta, cam, pcs, device="cpu")).numpy()
    assert img.max() > 0 and bad_pixels(img, ref) <= 4


def test_accel_cache_carries_octant_threads(tmp_path):
    """A port-written cache with the octant threads loads in the JAX
    package with them, and the JAX package's loads in the port with them."""
    from raytracer_tpu.utils.checkpoint import load_accel as jload
    from raytracer_tpu.utils.checkpoint import save_accel as jsave
    from raytracer_tpu_torch.models.bvh import OCT_FIELDS, build_bvh
    from raytracer_tpu_torch.models.clusters import build_clusters
    from raytracer_tpu_torch.utils.checkpoint import load_accel, save_accel

    _, _, jbvh, jcs = jax_accel("terrain16")
    data, meta = port_scene("terrain16")
    bvh = build_bvh(data, meta, ordered=True)
    save_accel(str(tmp_path / "port.npz"), bvh, build_clusters(data, meta, bvh))
    jsave(str(tmp_path / "jax.npz"), jbvh, jcs)
    jbvh2, _ = jload(str(tmp_path / "port.npz"))
    pbvh, _ = load_accel(str(tmp_path / "jax.npz"), device="cpu")
    for f in OCT_FIELDS:
        want = np.asarray(getattr(jbvh, f))
        np.testing.assert_array_equal(np.asarray(getattr(jbvh2, f)), want, f)
        np.testing.assert_array_equal(getattr(pbvh, f), want, f)
