"""The port's kernel modules (run through their plain PyTorch versions on
the CPU) against the JAX package's: the slab masks, shortlist compaction
and the closest-hit kernel in both call shapes, on one accelerator built
by the JAX package and handed across.  See torch_port_util for why
continuous outputs carry tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.ops import cluster_trace as jct
from raytracer_tpu_torch.ops import cluster_trace as pct
from raytracer_tpu_torch.ops import kernels as K
from torch_port_util import (
    assert_same, float32_ambiguous, jax_accel, prim_slots, scene_rays,
    shared_inputs,
)

R = 1024  # a multiple of TILE * TPB = 1024 on the JAX side


def _boxes(cs):
    cmin = np.concatenate([np.asarray(cs.tri_cmin), np.asarray(cs.sph_cmin)])
    cmax = np.concatenate([np.asarray(cs.tri_cmax), np.asarray(cs.sph_cmax)])
    return cmin, cmax


def _mask_inputs(scene, seed=1):
    _, _, _, cs = jax_accel(scene)
    o, d, act = scene_rays(cs, R, seed)
    d[::9, 0] = 0.0  # zero direction components take the _BIG sentinel
    thi = np.random.default_rng(seed).uniform(0.3, 1.5, R).astype(np.float32)
    return (o, d, act) + _boxes(cs) + (thi,)


@pytest.mark.parametrize("scene", ["terrain64", "spheres1200", "entry"])
def test_ray_mask_equals_eager_jnp(scene):
    """Bit for bit against _ray_mask_jnp run op by op (its docstring: the
    same math as the Pallas kernel, bitwise)."""
    o, d, act, cmin, cmax, thi = _mask_inputs(scene)
    with jax.disable_jit():
        jh, je = jct._ray_mask_jnp(*map(jnp.asarray, (o, d, act, cmin, cmax, thi)),
                                   128)
    ph, pe = pct.ray_cluster_mask(*map(torch.from_numpy, (o, d, act, cmin, cmax, thi)),
                                  128)
    assert np.asarray(jh).any()
    assert_same(ph.numpy(), jh, "hit")
    assert_same(pe.numpy(), je, "entry")


@pytest.mark.parametrize("scene", ["terrain64", "spheres1200"])
def test_ray_mask_matches_pallas_interpret(scene):
    """Against the Pallas kernel itself (interpret mode): equal hit bits;
    entries within 1e-5 relative + 1e-5 absolute (XLA contracts
    c*inv - o*inv into an FMA there: a few ulps of the products)."""
    o, d, act, cmin, cmax, thi = _mask_inputs(scene, seed=2)
    jh, je = jax.jit(jct._ray_cluster_mask_tpu, static_argnums=(6, 7))(
        *map(jnp.asarray, (o, d, act, cmin, cmax, thi)), 128, True)
    ph, pe = pct.ray_cluster_mask(*map(torch.from_numpy, (o, d, act, cmin, cmax, thi)),
                                  128)
    jh, je = np.asarray(jh), np.asarray(je)
    assert_same(ph.numpy(), jh, "hit")
    np.testing.assert_allclose(pe.numpy()[jh], je[jh], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c", [1, 32, 33, 249])
def test_ray_mask_plain_ray_order_invariant(c):
    """What a mask kernel that splits a tile's rays over threads relies on:
    hit and entry do not depend on the order of the rays in a tile.  Random
    rays and boxes (some NaN: empty clusters), zero direction components
    (the _BIG sentinel), inactive rays and a tile without an active ray;
    the rays of each tile permuted."""
    rng = np.random.default_rng(c)
    nt = 6
    r = nt * K.TILE
    o = rng.uniform(-2, 2, (r, 3)).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d[::7, 1] = 0.0
    act = rng.random(r) < 0.8
    act[K.TILE:2 * K.TILE] = False
    thi = rng.uniform(0.5, 4.0, r).astype(np.float32)
    cmin = rng.uniform(-3, 2, (c, 3)).astype(np.float32)
    cmax = (cmin + rng.uniform(0.05, 1.5, (c, 3))).astype(np.float32)
    cmin[1::5] = cmax[1::5] = np.nan
    act_t, bundle = pct._mask_bundle(*map(torch.from_numpy, (o, d, act, thi)), K.TILE)
    box = pct._box_table(torch.from_numpy(cmin), torch.from_numpy(cmax))
    hit, ent = K.ray_mask_plain(act_t, box, bundle)
    perm = np.concatenate([t * K.TILE + rng.permutation(K.TILE) for t in range(nt)])
    hit2, ent2 = K.ray_mask_plain(act_t, box, bundle[:, perm].contiguous())
    assert hit.any() and not hit[1].any()
    assert torch.equal(hit, hit2) and torch.equal(ent, ent2)


def test_tile_mask_equals_jax():
    """The interval tile mask of eye wavefronts: no a*b+c in it, so it is
    compared exactly against the jitted JAX function."""
    _, _, _, cs = jax_accel("terrain16")
    o, d, act = scene_rays(cs, R, 3)
    o[:] = o[0]  # one shared origin
    act[:256] = False  # two fully inactive tiles
    cmin, cmax = _boxes(cs)
    jh, je = jax.jit(jct.tile_cluster_mask, static_argnums=(6,))(
        *map(jnp.asarray, (o, d, act, cmin, cmax)), None, 128)
    ph, pe = pct.tile_cluster_mask(*map(torch.from_numpy, (o, d, act, cmin, cmax)),
                                   None, 128)
    assert_same(ph.numpy(), jh, "hit")
    assert_same(pe.numpy(), je, "entry")
    assert not ph[:2].any()


def _tile_mask_args():
    _, _, _, cs = jax_accel("terrain16")
    o, d, act = scene_rays(cs, R, 3)
    o[:] = o[0]
    cmin, cmax = _boxes(cs)
    th = np.random.default_rng(3).uniform(5.0, 60.0, R).astype(np.float32)
    return [torch.from_numpy(x) for x in (o, d, act, cmin, cmax, th)]


def test_tile_mask_cpu_takes_plain(monkeypatch):
    """On CPU tensors the wrapper returns its plain version's result
    (``tile_cluster_mask`` goes through it) and counts no launch."""
    o, d, act, cmin, cmax, th = _tile_mask_args()
    calls = []
    plain = K.tile_mask_plain

    def spy(*a):
        calls.append(a)
        return plain(*a)

    monkeypatch.setattr(K, "tile_mask_plain", spy)
    K.reset_launches()
    hit, entry = pct.tile_cluster_mask(o, d, act, cmin, cmax, th, 128,
                                       subsplit=2)
    want = plain(o, d, act, cmin, cmax, th, 128, 2)
    assert len(calls) == 1 and K.launches["tile_mask"] == 0
    assert hit.any() and torch.equal(hit, want[0])
    assert torch.equal(entry, want[1])


@pytest.mark.parametrize("bad", ["dtype", "origin_shape", "box_shape",
                                 "active_shape", "t_hi_dtype", "device",
                                 "tiles", "subsplit"])
def test_tile_mask_rejects_bad_inputs(bad):
    """A wrong dtype, shape or device, or rays that do not split into
    whole tiles and sub-intervals, raise ValueError before any work."""
    o, d, act, cmin, cmax, th = _tile_mask_args()
    tile, sub = 128, 1
    if bad == "dtype":
        d = d.double()
    elif bad == "origin_shape":
        o = o[:, :2]
    elif bad == "box_shape":
        cmax = cmax[:-1]
    elif bad == "active_shape":
        act = act[:-128]
    elif bad == "t_hi_dtype":
        th = th.to(torch.float16)
    elif bad == "device":
        cmin = torch.empty(cmin.shape, device="meta")
    elif bad == "tiles":
        tile = 96
    else:
        sub = 3
    with pytest.raises(ValueError):
        K.tile_mask(o, d, act, cmin, cmax, th, tile, sub)


@pytest.mark.parametrize("chunk,calls", [(128, 32), (1 << 22, 1)])
def test_tile_mask_once_a_wavefront(chunk, calls, monkeypatch):
    """A 64x64 terrain frame on the cluster engine calls the interval tile
    mask once a shared-eye wavefront (bounce 0): 32 when the frame runs in
    wavefronts of one tile (as the big frame's 32 bands), 1 when it runs
    whole; every call on the frame's eye origin."""
    from raytracer_tpu_torch.models.bvh import build_bvh
    from raytracer_tpu_torch.models.clusters import build_clusters
    from raytracer_tpu_torch.models.whitted import render_camera
    from raytracer_tpu_torch.utils import synth

    data, meta = synth.terrain_scene(cells=12, res=64, device="cpu")
    cset = build_clusters(data, meta, build_bvh(data, meta))
    seen = []
    mask = K.tile_mask

    def spy(origin, *a):
        seen.append(bool((origin == origin[0]).all()))
        return mask(origin, *a)

    monkeypatch.setattr(K, "tile_mask", spy)
    render_camera(data, meta, meta.cameras[0], cset, chunk=chunk, device="cpu")
    assert len(seen) == calls and all(seen)


@pytest.mark.parametrize("c,max_list,offset", [
    pytest.param(5, 8, 0, id="5-8"), pytest.param(37, 8, 0, id="37-8"),
    pytest.param(70, 48, 0, id="70-48"), pytest.param(0, 8, 0, id="0-8"),
    pytest.param(20, 48, 0, id="20-48"), pytest.param(4099, 48, 0, id="4099-48"),
    pytest.param(70, 48, 13, id="70-48-slice")])
def test_compact_equals_jax(c, max_list, offset):
    """Front-to-back lists with ties (lower cluster id first, like
    lax.top_k), unclamped counts and the bitmask words; no columns, fewer
    columns than the list holds, a partial last word, and (``offset``) the
    mask as a column slice of a wider one, read in place, as the triangle
    and sphere slices of one concatenated mask are."""
    rng = np.random.default_rng(c)
    nt = 16
    width = offset + c + (5 if offset else 0)
    hit = rng.random((nt, width)) < 0.6
    hit[0] = True          # overflows small lists
    hit[1] = False         # empty tile
    entry = rng.integers(0, 6, (nt, width)).astype(np.float32)  # many ties
    entry[2] = -0.0        # (lax.top_k orders -0 before +0; the port as equal)
    th, te = torch.from_numpy(hit), torch.from_numpy(entry)
    hit, entry = hit[:, offset:offset + c], entry[:, offset:offset + c]
    th, te = th[:, offset:offset + c], te[:, offset:offset + c]
    assert th.is_contiguous() == (offset == 0)
    with jax.disable_jit():
        jw, jids, jel, jcnt = jct._compact(jnp.asarray(hit), jnp.asarray(entry), max_list)
    pw, pids, pel, pcnt = pct._compact(th, te, max_list)
    assert_same(pw.numpy(), jw, "words")
    assert_same(pcnt.numpy(), jcnt, "counts")
    cnt = np.minimum(np.asarray(jcnt), max_list)
    keep = np.arange(max_list)[None] < cnt[:, None]
    assert_same(pids.numpy().reshape(nt, -1)[keep],
                np.asarray(jids).reshape(nt, -1)[keep], "ids")
    assert_same(pel.numpy().reshape(nt, -1)[keep],
                np.asarray(jel).reshape(nt, -1)[keep], "entries")


def test_compact_cpu_takes_plain_version():
    """CPU tensors take the plain version (the stable sort) and count no
    kernel launch; so does the engine's ``_compact``."""
    rng = np.random.default_rng(3)
    hit = torch.from_numpy(rng.random((8, 300)) < 0.2)
    entry = torch.from_numpy(rng.integers(0, 9, (8, 300)).astype(np.float32))
    before = dict(K.launches)
    for got in (K.compact(hit, entry, 48), pct._compact(hit, entry, 48)):
        for a, b in zip(got, K.compact_plain(hit, entry, 48)):
            assert torch.equal(a, b)
    assert K.launches == before and "compact" in K.launches


def _rays(scene, shared, seed):
    data, meta, _, cs = jax_accel(scene)
    eye = np.asarray(meta.cameras[0].position, np.float32) if shared else None
    o, d, act = scene_rays(cs, R, seed, eye=eye)
    return cs, (o[0] if shared else o), d, act


def _excused(cs, o, d, jslot, pslot, jt, pt_):
    """The float32-ambiguous lanes (torch_port_util.float32_ambiguous):
    at most 1% of the rays."""
    ex = float32_ambiguous(cs, o, d, jslot, pslot, np.where(jslot >= 0, jt, np.inf),
                           np.where(pslot >= 0, pt_, np.inf))
    assert ex.sum() <= R // 100, f"{ex.sum()} ambiguous lanes"
    return ex


CLOSEST_CASES = [
    ("terrain16", False, False), ("terrain16", True, False),
    ("terrain16", False, True), ("terrain64", False, False),
    ("spheres600", False, False), ("spheres600", True, False),
    ("spheres1200", False, False), ("spheres1200", True, False),
    ("entry", True, False), ("entry", False, True),
]


@pytest.mark.parametrize("scene,shared,bfc", CLOSEST_CASES)
def test_closest_hit_matches_jax(scene, shared, bfc):
    """cluster_closest_hit end to end (mask, compaction, closest kernel,
    small-sphere merge, slot-table epilogue): hit, material and primitive
    equal, t within rtol 1e-4 and the points and normals within what that
    t bar allows, on every lane but the float32-ambiguous ones (edge and
    grazing hits, ties) where XLA's FMA contraction on the JAX side
    decides."""
    _, jcs, _, _, pcs = shared_inputs(scene)
    cs, o, d, act = _rays(scene, shared, seed=7)
    f = jax.jit(lambda o, d, a: jct.cluster_closest_hit(
        jcs, o, d, 1e-3, active=a, bfc=bfc, shared_origin=shared,
        with_slot=True))
    jhit, jt, jn, jmat, jpt, joff, jprim, jslot = [
        np.asarray(x) for x in f(*map(jnp.asarray, (o, d, act)))]
    phit, pt_, pn, pmat, ppt, poff, pprim = [x.numpy() for x in pct.cluster_closest_hit(
        pcs, torch.from_numpy(o), torch.from_numpy(d), 1e-3,
        active=torch.from_numpy(act), bfc=bfc, shared_origin=shared)]
    assert jhit.sum() > R // 32
    ok = ~_excused(cs, o, d, jslot, prim_slots(cs, pprim), jt, pt_)
    assert_same(phit[ok], jhit[ok], "hit")
    assert_same(pprim[ok], jprim[ok], "prim")
    assert_same(pmat[ok], jmat[ok], "mat")
    np.testing.assert_allclose(pt_[ok], jt[ok], rtol=1e-4)
    # the t bar moves a point by up to 1e-4 |t d|, plus rounding of o + t d
    p_tol = (1e-4 * np.abs(jt) * np.linalg.norm(d, axis=1)
             + 1e-6 * np.abs(jpt).max())[:, None]
    assert (np.abs(ppt - jpt)[ok] <= p_tol[ok]).all()
    assert (np.abs(poff - joff)[ok] <= p_tol[ok]).all()
    # triangle normals come from the slot table (equal); a sphere normal is
    # (point - center) / r
    pt_slots = np.asarray(cs.tri_dat).shape[1]
    tri = ok & jhit & (jslot < pt_slots)
    assert_same(pn[tri], jn[tri], "triangle normals")
    sph = ok & jhit & (jslot >= pt_slots)
    rad = np.where(sph, np.asarray(cs.sph_dat)[3][np.maximum(jslot - pt_slots, 0)],
                   1.0)
    n_tol = 2 * p_tol[:, 0] / rad + 1e-6
    assert (np.abs(pn - jn).max(1)[sph] <= n_tol[sph]).all()


@pytest.mark.parametrize("scene,shared,bfc", CLOSEST_CASES)
def test_closest_kernel_matches_jax(scene, shared, bfc):
    """The kernel module alone: the JAX package's own shortlists fed to the
    port's closest kernel (plain version) and to the JAX call; slots equal
    and t within rtol 1e-4 on every active lane but the float32-ambiguous
    ones."""
    _, jcs, _, _, pcs = shared_inputs(scene)
    cs, org, d, act = _rays(scene, shared, seed=11)
    ob = np.broadcast_to(org, d.shape).copy()
    mask_fn = jct.tile_cluster_mask if shared else None
    thit, shit = jax.jit(lambda o, d, a: jct._cluster_masks(
        jcs, o, d, a, None, mask_fn=mask_fn))(*map(jnp.asarray, (ob, d, act)))
    call = jct._cluster_closest_call_shared if shared else jct._cluster_closest_call
    jt, js = call(thit, shit, jnp.asarray(org), jnp.asarray(d), jcs.tri_dat,
                  jcs.sph_dat, cs.n_tri, cs.n_sph, bfc)
    jt, js = np.asarray(jt), np.asarray(js)
    to_t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    lists = pct._lists((to_t(thit[0]), to_t(thit[1])),
                       (to_t(shit[0]), to_t(shit[1])))
    if scene == "terrain64":  # some tile takes the bitmask scan
        assert int(lists[2].max()) > K.MAX_TRI_LIST
    pt_, ps = K.closest(*lists, to_t(org), to_t(d), pcs.tri_dat, pcs.sph_dat, bfc)
    pt_, ps = pt_.numpy(), ps.numpy()
    assert (js[act] >= 0).sum() > R // 32
    ok = act & ~_excused(cs, org, d, js, ps, jt, pt_)
    assert_same(ps[ok], js[ok], "slot")
    fin = ok & (js >= 0)
    np.testing.assert_allclose(pt_[fin], jt[fin], rtol=1e-4)


@pytest.mark.parametrize("scene,bfc", [("terrain16", False), ("terrain16", True),
                                       ("entry", False), ("spheres600", False)])
def test_shadow_planes_equal(scene, bfc):
    """build_shadow_planes bit for bit against the JAX function run op by op."""
    jdata, jcs, pdata, _, pcs = shared_inputs(scene)
    for l in range(int(np.asarray(jdata.light_valid).sum())):
        with jax.disable_jit():
            jp = jct.build_shadow_planes(jcs, jdata.light_pos[l], bfc=bfc)
        pp = pct.build_shadow_planes(pcs, pdata.light_pos[l], bfc=bfc)
        assert pp.shape == (16, pcs.tri_dat.shape[1])
        assert_same(pp.numpy(), jp, f"planes light {l}")


@pytest.mark.parametrize("scene", ["entry", "spheres1200"])
def test_slot_to_prim_equals_jax(scene):
    _, jcs, _, _, pcs = shared_inputs(scene)
    n = pcs.tri_dat.shape[1] + pcs.sph_dat.shape[1]
    slot = np.concatenate([np.arange(-1, n), [-1, 0, n - 1]]).astype(np.int32)
    with jax.disable_jit():
        jp = np.asarray(jct._slot_to_prim(jcs, jnp.asarray(slot)))
    pp = pct._slot_to_prim(pcs, torch.from_numpy(slot)).numpy()
    assert_same(pp, jp, "prim")


# ---------------------------------------------------------------------------
# exact ties (tests/torch_tie_case.py): the (t, lane, visit) winner rule
# ---------------------------------------------------------------------------

def _tie_inputs(shared):
    from torch_tie_case import tie_case

    c = tie_case()
    o, d = (c["eye"], c["eye_dirs"]) if shared else (c["origin"], c["dirs"])
    to_t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    lists = pct._lists(tuple(map(to_t, c["thit"])), tuple(map(to_t, c["shit"])))
    return c, o, d, lists, to_t


def _tie_stats(c, o, d, lists, slot, bfc):
    """Over the rays that hit: how many have more than one candidate at
    their least t (an exact tie), how many of those were won at a later
    visit than a tied candidate (by a lower lane), and how many ties mix a
    sphere with a triangle.  Replayed in float64, exact on this case."""
    tri, sph = c["tri_dat"].astype(np.float64), c["sph_dat"].astype(np.float64)
    ct, pt = tri.shape[1] // 128, tri.shape[1]
    tw, tl, tc, sw, sl, sc = lists
    vis = K._visit_table(tw, tl, tc, ct, K.MAX_TRI_LIST, 0, tc.shape[0]).numpy()
    o = np.broadcast_to(o, d.shape).astype(np.float64)
    d = d.astype(np.float64)
    tied = later = mixed = 0
    for i in range(tc.shape[0]):
        rays = slice(i * 128, (i + 1) * 128)
        oo, dd = o[rays, :, None], d[rays, :, None]
        cand = []   # (t (128 rays, 128 lanes), pos, cluster id incl. sphere offset)
        seq = [k for k in vis[i] if k >= 0]
        for pos, k in enumerate(seq):
            r = tri[:, k * 128:(k + 1) * 128]
            nd = (dd * r[0:3][None]).sum(1)
            with np.errstate(divide="ignore", invalid="ignore"):
                t = (r[9] - (oo * r[0:3][None]).sum(1)) / nd
            p = oo + t[:, None] * dd
            beta = (p * r[3:6][None]).sum(1) - r[10]
            gamma = (p * r[6:9][None]).sum(1) - r[11]
            ok = (beta >= 0) & (gamma >= 0) & (1 - beta - gamma >= 0) & (t >= 0)
            if bfc:
                ok &= nd < 0
            cand.append((np.where(ok, t, np.inf), pos, k))
        if int(sc[i]) != 0:
            oc = oo - sph[0:3][None]
            a = (dd * dd).sum(1)
            b = 2 * (dd * oc).sum(1)
            disc = b * b - 4 * a * ((oc * oc).sum(1) - sph[3] ** 2)
            sq = np.sqrt(np.maximum(disc, 0))
            t1 = (-b - sq) / (2 * a)
            ok = (disc >= 0) & ~((t1 < 0) & (sq - b < 0)) & (sph[3] > 0)
            cand.append((np.where(ok, t1, np.inf), len(seq), ct))
        if not cand:
            continue
        ts = np.stack([x[0] for x in cand])                  # (V, rays, lanes)
        best = ts.min((0, 2))
        at_best = (ts == best[None, :, None]) & np.isfinite(best)[None, :, None]
        n_best = at_best.sum((0, 2))
        for j in np.nonzero(n_best > 1)[0]:
            tied += 1
            s = int(slot[i * 128 + j])
            k = s // 128 if s < pt else ct + (s - pt) // 128
            pos = [x[1] for x in cand if x[2] == k][0]
            earliest = min(x[1] for v, x in enumerate(cand) if at_best[v, j].any())
            later += pos > earliest
            kinds = {x[2] >= ct for v, x in enumerate(cand) if at_best[v, j].any()}
            mixed += len(kinds) == 2
    return tied, later, mixed


@pytest.mark.parametrize("shared,bfc", [(False, False), (False, True),
                                        (True, False), (True, True)])
def test_closest_exact_ties_match_jax(shared, bfc):
    """The closest kernel (plain version) against the JAX package's
    _closest_kernel (interpret mode, the call shape of ``shared``) on the
    tie case: t and slot EQUAL on every ray, no tolerance (every float
    operation of the case is exact, so XLA's FMA contraction cannot move
    a result).  The case holds exact ties won by the lower lane at a
    later visit, list overflows, a sphere-only and an empty tile, and
    (per-ray origin) sphere-triangle ties."""
    c, o, d, lists, to_t = _tie_inputs(shared)
    thit = tuple(map(jnp.asarray, c["thit"]))
    shit = tuple(map(jnp.asarray, c["shit"]))
    call = jct._cluster_closest_call_shared if shared else jct._cluster_closest_call
    jt, js = call(thit, shit, jnp.asarray(o), jnp.asarray(d), jnp.asarray(c["tri_dat"]),
                  jnp.asarray(c["sph_dat"]), 200, 4, bfc)
    pt_, ps = K.closest(*lists, to_t(o), to_t(d), to_t(c["tri_dat"]),
                        to_t(c["sph_dat"]), bfc)
    assert int(lists[2].max()) > K.MAX_TRI_LIST
    assert_same(ps.numpy(), np.asarray(js), "slot")
    assert_same(pt_.numpy(), np.asarray(jt), "t")
    assert (ps[6 * 128:7 * 128] == -1).all()          # the empty tile
    tied, later, mixed = _tie_stats(c, o, d, lists, ps.numpy(), bfc)
    print(f"shared={shared} bfc={bfc}: {int((ps >= 0).sum())} hits, {tied} tied, "
          f"{later} won at a later visit by a lower lane, {mixed} sphere-triangle")
    assert tied > 100 and later > 10
    assert mixed > 0 or shared


@pytest.mark.parametrize("bfc,relaxed", [(False, False), (False, True),
                                         (True, False), (True, True)])
def test_any_hit_exact_ties_match_jax(bfc, relaxed):
    """The any-hit kernel (plain version) against the JAX package's
    _any_kernel (interpret mode) on the tie case with t_max at exactly a
    layer's t and at the sphere tops (t < t_max is strict): found bits
    EQUAL on every ray."""
    c, o, d, lists, to_t = _tie_inputs(False)
    jf = np.asarray(jct._cluster_any_call(
        tuple(map(jnp.asarray, c["thit"])), tuple(map(jnp.asarray, c["shit"])),
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(c["t_max"])[:, None],
        jnp.asarray(c["tri_dat"]), jnp.asarray(c["sph_dat"]), 200, 4, bfc, relaxed))
    pf = K.any_hit(*lists, to_t(o), to_t(d), to_t(c["t_max"]), to_t(c["tri_dat"]),
                   to_t(c["sph_dat"]), bfc, relaxed).numpy() != 0
    assert 100 < pf.sum() < pf.size - 100
    assert_same(pf, jf, "found")
