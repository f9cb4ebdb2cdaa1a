"""The cluster engine around its kernels (port of the glue in
``raytracer_tpu/ops/cluster_trace.py``).

Per trace call:

1. A per-tile cluster mask: the exact per-ray slab test OR-reduced over
   each 128-ray tile (``ray_cluster_mask``, the ``ray_mask`` kernel; above
   SUPER_MIN_CPAD columns first against supercluster boxes, then
   ``ray_mask_hier`` on the chunks the tile crosses), or for shared-origin
   eye tiles the interval-arithmetic tile test (``tile_cluster_mask``,
   the ``tile_mask`` kernel).
2. ``_compact`` (the ``compact`` kernel): the mask becomes a
   front-to-back id list per tile (ties keep the lower cluster id, like
   ``lax.top_k``), an unclamped count and a bitmask for tiles whose list
   overflows.
3. The ``closest``, ``shadow`` or ``any_hit`` kernel visits each tile's
   candidates.

Scenes with 1 to SMALL_SPH spheres test them densely over all rays
instead.  On the forward bounces that test, the closest kernel's hit
record (``slot_hits``) and the shading run in the epilogue kernels
(``hit_record``, ``shade_bounce``: scene-level entry points whose CPU
tensors take the plain versions beside them, their CUDA tensors
``kernels.hit_record`` and ``kernels.shade_bounce``): the forward path
calls ``cluster_closest_slots`` and the occlusion routes with
``small_spheres`` False.  ``cluster_closest_hit`` and the routes at their
default keep the dense test and the record in PyTorch ops (the
differentiable path's visibility, the tests).

Visibility carries no gradient: the entry points (and the plane-table
build) run under ``torch.no_grad()`` on detached inputs, where the JAX
package calls ``stop_gradient``; the differentiable path re-derives hits
from ``cluster_closest``'s primitive ids (``ops.shade.refine_hit``).

The TPU scaffolding is not ported: the ``MAX_NT`` splits (SMEM budget),
``TPB`` tiles per program and the ``SEG_SLOTS`` segmentation (VMEM
residency).  The CUDA kernels read the tables from device memory at any
size, and the JAX package's own tests pin its segmented path equal to
the unsegmented one.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from raytracer_tpu_torch.models.clusters import ClusterSet
from raytracer_tpu_torch.ops import kernels, shade
from raytracer_tpu_torch.ops.kernels import BIG, MAX_SPH_LIST, MAX_TRI_LIST, TILE
from raytracer_tpu_torch.ops.shade import cross

MISS = -1
_INF = float("inf")

# scenes with at most this many spheres test them densely over all rays
# (and merge) instead of visiting sphere clusters in the kernels
SMALL_SPH = 8

# per-light shadow plane tables above this size take the generic any-hit
# kernel (cluster_any), as in the JAX package
SHADOW_PLANES_BYTES_MAX = 8 << 20

# Hierarchical mask: above SUPER_MIN_CPAD cluster columns (padded to a
# multiple of 128) each tile is first slab-tested against the unions of
# _SUPER consecutive clusters (superclusters), and only the 128-cluster
# chunks it crosses get the per-cluster test, so per-tile mask work
# follows the geometry the tile crosses instead of the cluster count.
# The JAX package's threshold, without its environment override.
_SUPER = 128
SUPER_MIN_CPAD = 512

# the (4,) int64 buffer that counting_masks sets for this thread
_counting = threading.local()


def _hierarchical(c: int) -> bool:
    """Whether a mask over ``c`` cluster columns takes the hierarchical
    route."""
    return -(-c // _SUPER) * _SUPER > SUPER_MIN_CPAD


def hierarchical(cset: ClusterSet) -> bool:
    """Whether the scene's exact masks (``_cluster_masks``: its triangle
    clusters, and its sphere clusters beyond SMALL_SPH spheres) take the
    hierarchical route."""
    c = cset.tri_cmin.shape[0]
    if cset.n_sph > SMALL_SPH:
        c += cset.sph_cmin.shape[0]
    return _hierarchical(c)


@contextlib.contextmanager
def counting_masks(counts):
    """Inside the block, each hierarchical ``ray_cluster_mask`` call of
    this thread adds [its active tiles, the live (tile, 128-cluster chunk)
    pairs its supercluster pass hands ``ray_mask_hier``] to ``counts[:2]``
    and each shortlist compaction (``_lists``, inside the ``compact``
    kernel: no launch of its own) [its tiles with a candidate, those whose
    count passes MAX_TRI_LIST / MAX_SPH_LIST, which the visitors walk as
    the bitmask] to ``counts[2:]`` ((4,) int64 on the rays' device; None
    counts nothing)."""
    outer = getattr(_counting, "counts", None)
    _counting.counts = counts
    try:
        yield
    finally:
        _counting.counts = outer


def tile_cluster_mask(origin, dirs, active, cmin, cmax, t_hi, tile: int,
                      subsplit: int = 1):
    """(hit (nt, C) bool, entry lower bound (nt, C) f32): could any ray of
    the tile hit the cluster box?  Interval arithmetic over the tile's
    origin and direction boxes (conservative; near-tight for the coherent
    frusta of shared-origin eye tiles).  ``active``: (R,) or None;
    ``t_hi``: (R,) upper bound of the useful t per ray, or None (closest-
    hit waves).  With ``subsplit`` > 1 each tile is tested as that many
    sub-intervals of consecutive rays whose results are merged (hit: any;
    entry: the least over the sub-intervals that hit), tighter for tiles
    whose origins straddle depth discontinuities.  CUDA tensors take the
    ``tile_mask`` kernel, CPU tensors its plain version
    (``kernels.tile_mask``)."""
    return kernels.tile_mask(origin, dirs, active, cmin, cmax, t_hi, tile,
                             subsplit)


def _super_boxes(cmin, cmax, cpad: int):
    """(S, 3) NaN-aware unions of each 128-cluster chunk's boxes (S =
    cpad / 128; NaN boxes, empty or padding clusters, are left out and an
    all-NaN chunk stays NaN, as ``jnp.nanmin`` gives: it never hits),
    dilated by 1e-5 |x| + 1e-30 so that a coarse miss implies a fine miss
    whatever the rounding (the JAX package's reason: its coarse and fine
    passes ran under two compilers)."""
    c = cmin.shape[0]
    s = cpad // _SUPER
    nan = torch.full((cpad - c, 3), float("nan"), dtype=cmin.dtype,
                     device=cmin.device)
    lo = torch.cat([cmin, nan]).reshape(s, _SUPER, 3)
    hi = torch.cat([cmax, nan]).reshape(s, _SUPER, 3)
    empty = torch.isnan(lo).all(1)
    smin = torch.where(torch.isnan(lo), _INF, lo).amin(1)
    smax = torch.where(torch.isnan(hi), -_INF, hi).amax(1)
    smin = torch.where(empty, float("nan"), smin)
    smax = torch.where(torch.isnan(hi).all(1), float("nan"), smax)
    eps = torch.full((), 1e-5, dtype=torch.float32, device=cmin.device)
    tiny = torch.full((), 1e-30, dtype=torch.float32, device=cmin.device)
    smin = smin - (eps * torch.abs(smin) + tiny)
    smax = smax + (eps * torch.abs(smax) + tiny)
    return smin, smax


def _box_table(cmin, cmax):
    """(8, C) kernel box rows [cmin xyz, BIG, cmax xyz, BIG]."""
    box = torch.full((8, cmin.shape[0]), BIG, dtype=torch.float32,
                     device=cmin.device)
    box[0:3] = cmin.T
    box[4:7] = cmax.T
    return box


def _mask_bundle(origin, dirs, active, t_hi, tile: int):
    """(act (nt,) i32, bundle (8, R) f32) of the mask kernels: per tile,
    whether any ray is active; per ray [o*inv (3), t_hi, inv (3), 0] with
    inv the reciprocal direction clamped to +-BIG (BIG for a zero
    component) and t_hi folded with the active mask (-inf: inactive)."""
    r = dirs.shape[0]
    nt = r // tile
    dev = dirs.device
    nz = dirs != 0.0
    inv = torch.where(
        nz, torch.clamp(1.0 / torch.where(nz, dirs, 1.0), -BIG, BIG), BIG)
    oi = origin * inv
    thi = (torch.full((r,), _INF, device=dev) if t_hi is None else t_hi)
    if active is not None:
        thi = torch.where(active, thi, -_INF)
        act = active.reshape(nt, tile).any(1).to(torch.int32)
    else:
        act = torch.ones((nt,), dtype=torch.int32, device=dev)
    bundle = torch.cat([oi.T, thi[None], inv.T,
                        torch.zeros((1, r), dtype=torch.float32, device=dev)])
    return act, bundle.contiguous()


def ray_cluster_mask(origin, dirs, active, cmin, cmax, t_hi, tile: int):
    """(hit (nt, C) bool, entry (nt, C) f32): does ANY ray of the tile
    cross the cluster box within its t window (the reference's slab test
    per ray), and the least slab entry over those rays (+inf when none).

    Zero direction components use the FINITE reciprocal sentinel BIG, so
    both slab planes land on the same huge-t side exactly when the origin
    is outside the slab, without NaN.  The per-ray terms (o*inv, inv, the
    t window folded with the active mask) are precomputed here into the
    kernel's (8, R) bundle.  Above SUPER_MIN_CPAD columns the hierarchical
    route gives the same result: the ``ray_mask`` kernel against the
    supercluster boxes (``_super_boxes``), then ``ray_mask_hier``, its
    work counted inside ``counting_masks``."""
    act, bundle = _mask_bundle(origin, dirs, active, t_hi, tile)
    c = cmin.shape[0]
    if _hierarchical(c):
        cpad = -(-c // _SUPER) * _SUPER
        sup, _ = kernels.ray_mask(act, _box_table(*_super_boxes(cmin, cmax, cpad)),
                                  bundle)
        counts = getattr(_counting, "counts", None)
        if counts is not None:
            counts[:2].add_(torch.stack([act.sum(), sup.sum()]))
        hit, ent = kernels.ray_mask_hier(act, sup.reshape(-1), _box_table(cmin, cmax),
                                         bundle)
    else:
        hit, ent = kernels.ray_mask(act, _box_table(cmin, cmax), bundle)
    return hit != 0, ent


def _compact(hit, entry, max_list: int, tally=None):
    """(hit, entry) (nt, C) -> (words (nt*W,) i32, ids (nt*max_list,) i32,
    elist (nt*max_list,) f32, counts (nt,) i32).

    ``ids`` holds each tile's first max_list candidates sorted FRONT TO
    BACK by slab entry (the order decides exact-t ties in the closest
    kernel); ``counts`` is unclamped, so a kernel can see the overflow and
    scan the bitmask ``words`` instead.  CUDA tensors take the ``compact``
    kernel, CPU tensors its plain version (``kernels.compact``), either
    adding to ``tally`` when given."""
    return kernels.compact(hit, entry, max_list, tally)


def _lists(thit, shit):
    """Triangle and sphere shortlists (tw, tl, tc, sw, sl, sc), counted
    inside ``counting_masks``."""
    counts = getattr(_counting, "counts", None)
    tally = None if counts is None else counts[2:]
    tw, tl, _, tc = _compact(*thit, MAX_TRI_LIST, tally)
    sw, sl, _, sc = _compact(*shit, MAX_SPH_LIST, tally)
    return tw, tl, tc, sw, sl, sc


def _empty_shit(nt: int, cs: int, device):
    return (torch.zeros((nt, cs), dtype=torch.bool, device=device),
            torch.full((nt, cs), _INF, device=device))


def _cluster_masks(cset: ClusterSet, origin, dirs, active, t_hi,
                   mask_fn=ray_cluster_mask):
    """ONE mask pass over the concatenated triangle+sphere cluster boxes,
    split into (thit, shit).  Scenes with at most SMALL_SPH spheres get an
    EMPTY sphere shortlist: their spheres are tested densely instead."""
    ct_n = cset.tri_cmin.shape[0]
    if cset.n_sph <= SMALL_SPH:
        thit = mask_fn(origin, dirs, active, cset.tri_cmin, cset.tri_cmax,
                       t_hi, TILE)
        return thit, _empty_shit(thit[0].shape[0], cset.sph_cmin.shape[0],
                                 dirs.device)
    cmin = torch.cat([cset.tri_cmin, cset.sph_cmin])
    cmax = torch.cat([cset.tri_cmax, cset.sph_cmax])
    hit, ent = mask_fn(origin, dirs, active, cmin, cmax, t_hi, TILE)
    return (hit[:, :ct_n], ent[:, :ct_n]), (hit[:, ct_n:], ent[:, ct_n:])


def _sum3(x):
    return x[0] + x[1] + x[2]


@torch.no_grad()
def build_shadow_planes(cset: ClusterSet, light_pos, bfc: bool = False):
    """(16, Pt) f32 per-light occlusion planes for every triangle slot.

    A shadow ray is a SEGMENT from a surface point o to the light L, so the
    reference's triangle test (barycentrics >= 0 and 0 <= t < d) is four
    sign tests of planes that depend only on (triangle, L): the supporting
    plane and the planes through L and each edge, scaled by one orientation
    sigma = -sign(n.(L-A)).  Occluded <=> all four, evaluated at o, are
    >= 0.  Rows: [0:4] sigma*(n, -n.A) (the d-row is -1 on degenerate or
    padding slots so they never occlude), [4:8] sigma*(m1, -m1.L) with
    m1 = (A-L)x(B-L), [8:12] edge BC, [12:16] edge CA.  ``bfc`` culls
    back-facing occluders."""
    sv = cset.tri_verts
    a, b, c = sv[0:3], sv[3:6], sv[6:9]
    lp = light_pos.detach().to(torch.float32).reshape(3, 1)
    n = cross(b - a, c - a)
    d0 = -_sum3(n * a)
    k0 = _sum3(n * (lp - a))
    la, lb, lc = a - lp, b - lp, c - lp
    m1 = cross(la, lb)
    m2 = cross(lb, lc)
    m3 = cross(lc, la)
    c1 = -_sum3(m1 * lp)
    c2 = -_sum3(m2 * lp)
    c3 = -_sum3(m3 * lp)
    ok = k0 < 0.0 if bfc else k0 != 0.0
    s = torch.where(ok, -torch.sign(k0), 0.0)
    d0 = torch.where(ok, s * d0, -1.0)
    return torch.cat([
        s * n, d0[None],
        s * m1, (s * c1)[None],
        s * m2, (s * c2)[None],
        s * m3, (s * c3)[None],
    ], dim=0).contiguous()


def _pad_rays(origin, dirs, *extras):
    """Pad the ray axis to a multiple of TILE with copies of the last ray;
    extra per-ray tensors (or None) are padded with zeros.  Returns
    (r, origin, dirs, *extras)."""
    r = dirs.shape[0]
    pad = (-r) % TILE
    if pad == 0:
        return (r, origin, dirs) + extras
    origin = torch.cat([origin, origin[-1:].expand(pad, 3)])
    dirs = torch.cat([dirs, dirs[-1:].expand(pad, 3)])
    out = []
    for e in extras:
        out.append(None if e is None else torch.cat(
            [e, torch.zeros((pad,) + tuple(e.shape[1:]), dtype=e.dtype,
                            device=e.device)]))
    return (r, origin, dirs) + tuple(out)


def _sph_rows(cset: ClusterSet):
    n = cset.n_sph
    return [cset.sph_dat[i, :n][None] for i in range(4)]


def _small_sphere_test(cset: ClusterSet, origin, dirs):
    """(t, ok) of shape (R, n_sph): the kernels' sphere quadratic over
    every (ray, sphere) pair."""
    ox, oy, oz = origin[:, 0:1], origin[:, 1:2], origin[:, 2:3]
    dx, dy, dz = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
    return kernels._sph_test(_sph_rows(cset), ox, oy, oz, dx, dy, dz)


def _small_sphere_occluded(cset: ClusterSet, origin, dirs, relaxed: bool,
                           t_max=1.0):
    """(R,) any sphere hit with t < t_max ((R, 1) or 1: the segment
    origin -> origin+dirs) on the ray origin + t dirs."""
    ox, oy, oz = origin[:, 0:1], origin[:, 1:2], origin[:, 2:3]
    dx, dy, dz = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
    return kernels._sph_occluded(_sph_rows(cset), ox, oy, oz, dx, dy, dz,
                                 relaxed, t_max).any(1)


def _small_sphere_test_multi(cset: ClusterSet, origin, lps, relaxed: bool):
    """(R, L) small-sphere occlusion toward every light."""
    return torch.stack([
        _small_sphere_occluded(cset, origin, lps[3 * l:3 * l + 3][None] - origin,
                               relaxed)
        for l in range(lps.shape[0] // 3)], dim=1)


def _merge_small_spheres(cset: ClusterSet, origin, dirs, t_k, slot_k):
    """Merge the kernel's (t, slot) with the dense small-sphere test under
    the kernel's rules: strict < so triangles keep exact-t ties, and the
    lowest sphere slot wins sphere-sphere ties."""
    t_s, ok = _small_sphere_test(cset, origin, dirs)
    t_s = torch.where(ok, t_s, _INF)
    tj, j = t_s.min(dim=1)
    t_kv = torch.where(slot_k >= 0, t_k, _INF)
    upd = tj < t_kv
    pt = cset.tri_dat.shape[1]
    slot = torch.where(upd, pt + j.to(torch.int32), slot_k)
    return torch.where(upd, tj, t_k), slot


def _slot_to_prim(cset: ClusterSet, slot):
    """Kernel slot -> global primitive id (MISS for slot < 0)."""
    pt = cset.tri_dat.shape[1]
    ps = cset.sph_dat.shape[1]
    tri_id = cset.tri_slot[torch.clamp(slot, 0, pt - 1).long()]
    sph_id = cset.sph_slot[torch.clamp(slot - pt, 0, ps - 1).long()]
    prim = torch.where(slot < pt, tri_id, sph_id)
    return torch.where(slot < 0, MISS, prim)


@torch.no_grad()
def cluster_closest(cset: ClusterSet, origin, dirs, active=None,
                    bfc: bool = False):
    """(R,) int64 global primitive ids of the closest hits (MISS on a miss)
    of rays ``origin`` ((3,) or (R, 3)) + t ``dirs``: the exact mask, the
    per-ray-origin closest kernel, the dense small-sphere merge."""
    dirs = dirs.detach().contiguous()
    origin = origin.detach().expand(dirs.shape).contiguous()
    r, origin, dirs, active = _pad_rays(origin, dirs, active)
    thit, shit = _cluster_masks(cset, origin, dirs, active, None)
    t, slot = kernels.closest(*_lists(thit, shit), origin, dirs,
                              cset.tri_dat, cset.sph_dat, bfc)
    if 0 < cset.n_sph <= SMALL_SPH:
        _, slot = _merge_small_spheres(cset, origin, dirs, t, slot)
    return _slot_to_prim(cset, slot)[:r].long()


@torch.no_grad()
def cluster_closest_slots(cset: ClusterSet, origin, dirs, active=None,
                          bfc: bool = False, shared_origin: bool = False):
    """(t, slot) of the closest kernel ((R_pad,): the rays padded to whole
    tiles) for rays ``origin`` + t ``dirs``: the tile masks and the
    shortlists, then the kernel.  ``origin``: (3,) with ``shared_origin``
    (eye wavefronts: interval tile mask and the shared-origin kernel),
    else (R, 3)."""
    shared = shared_origin and origin.dim() == 1
    org1 = origin.reshape(3).contiguous() if shared else None
    origin = origin.expand(dirs.shape).contiguous()
    r, origin, dirs, active = _pad_rays(origin, dirs.contiguous(), active)
    mask_fn = tile_cluster_mask if shared else ray_cluster_mask
    thit, shit = _cluster_masks(cset, origin, dirs, active, None, mask_fn)
    return kernels.closest(*_lists(thit, shit),
                           org1 if shared else origin, dirs,
                           cset.tri_dat, cset.sph_dat, bfc)


@torch.no_grad()
def slot_hits(cset: ClusterSet, origin, dirs, t, slot, shadow_eps: float):
    """The hit record of rays ``origin`` ((3,) or (R, 3)) + t ``dirs``
    (R, 3) from the closest kernel's (t, slot) (R or more, padded): the
    dense small-sphere merge, then ONE gather of the per-slot table.
    Returns (hit, t, normal, mat, point, offset, prim)."""
    r = dirs.shape[0]
    origin = origin.expand(dirs.shape)
    t, slot = t[:r], slot[:r]
    if 0 < cset.n_sph <= SMALL_SPH:
        t, slot = _merge_small_spheres(cset, origin, dirs, t, slot)
    hit = slot >= 0
    sslot = torch.where(hit, slot, 0).long()
    pt = cset.tri_dat.shape[1]
    pack = cset.slot_pack[sslot]
    aux = pack[:, 0:3]                  # tri: unit normal; sph: center
    rad = pack[:, 3]
    mat = torch.where(hit, pack[:, 4].long(), 0)
    t = torch.where(hit, t, 1.0)
    point = origin + t[:, None] * dirs
    sph_lane = hit & (sslot >= pt)
    up = torch.zeros((3,), device=dirs.device)   # (0, 0, 1), no host copy
    up[2:].fill_(1.0)
    safe_rad = torch.where(sph_lane, torch.clamp_min(rad, 1e-30), 1.0)
    n_raw = torch.where(sph_lane[:, None], (point - aux) / safe_rad[:, None], up)
    n_sphere = n_raw / torch.sqrt((n_raw * n_raw).sum(-1, keepdim=True))
    normal = torch.where(sph_lane[:, None], n_sphere, aux)
    normal = torch.where(hit[:, None], normal, up)
    offset = point + normal * shadow_eps   # f32 multiply, as in JAX
    prim = torch.where(hit, pack[:, 5].long(), MISS)
    return hit, t, normal, mat, point, offset, prim


@torch.no_grad()
def cluster_closest_hit(cset: ClusterSet, origin, dirs, shadow_eps: float,
                        active=None, bfc: bool = False,
                        shared_origin: bool = False):
    """Closest hit with shading info from the kernel's (t, slot) and ONE
    gather of the per-slot table (``cluster_closest_slots``, then
    ``slot_hits``).  ``origin``: (3,) with ``shared_origin``, else (R, 3).
    Returns (hit, t, normal, mat, point, offset, prim).  The forward
    bounces take the same record from :func:`hit_record`."""
    t, slot = cluster_closest_slots(cset, origin, dirs, active, bfc,
                                    shared_origin)
    return slot_hits(cset, origin, dirs, t, slot, shadow_eps)


def _n_small(cset: ClusterSet) -> int:
    """The spheres of a scene with 1 to SMALL_SPH of them, which are tested
    densely over all rays; 0 otherwise."""
    return cset.n_sph if 0 < cset.n_sph <= SMALL_SPH else 0


@torch.no_grad()
def hit_record(data, meta, cset: ClusterSet, t, slot, origin, dirs, active):
    """(Hit, mask (R, L) bool) of a forward bounce's rays ``origin`` ((3,)
    shared or (R, 3)) + t ``dirs`` (R, 3) from the closest kernel's (t,
    slot) (``cluster_closest_slots``): the record of :func:`slot_hits`
    with its hit ANDed with ``active`` (R,) bool and no ``t`` (nothing
    after it reads one), and the shadow pass's mask hit & relevant per
    light (``shade.light_terms``).  CPU tensors take the plain version,
    CUDA ones ``kernels.hit_record``."""
    if dirs.device.type == "cpu":
        return hit_record_plain(data, meta, cset, t, slot, origin, dirs,
                                active)
    hit, normal, mat, point, offset, mask = kernels.hit_record(
        t, slot, origin, dirs, active, cset.slot_pack, cset.sph_dat,
        data.light_pos[:meta.n_lights], _n_small(cset), meta.shadow_eps,
        shade.RELEVANT_COS)
    return shade.Hit(hit=hit, t=None, normal=normal, mat=mat, point=point,
                     offset=offset), mask


def hit_record_plain(data, meta, cset: ClusterSet, t, slot, origin, dirs,
                     active):
    """Plain PyTorch version of :func:`hit_record`: :func:`slot_hits`, then
    ``shade.light_terms``."""
    hit, _, normal, mat, point, offset, _ = slot_hits(cset, origin, dirs, t,
                                                      slot, meta.shadow_eps)
    h = shade.Hit(hit=hit & active, t=None, normal=normal, mat=mat,
                  point=point, offset=offset)
    return h, h.hit[:, None] & shade.light_terms(data, meta, h)[3]


@torch.no_grad()
def shade_bounce(data, meta, cset: ClusterSet, carry, h, occ, first: bool,
                 relaxed: bool = False, out=None):
    """The next (color, throughput, active, cur_org, cur_dir) of a forward
    bounce's ``carry`` (the same five; ``cur_org`` may be the shared (3,)
    origin) from its record ``h`` (:func:`hit_record`) and ``occ`` (R, L)
    bool, the occlusion route's bits without the small-sphere test (None
    without lights): that test ORed in, then ``shade.bounce`` (the
    background of a ``first`` bounce's misses, ambient and Blinn-Phong,
    color += throughput * local, the mirror reflection and the carry).
    CPU tensors take the plain version, which returns new tensors; CUDA
    ones ``kernels.shade_bounce``, which writes ``out`` (five tensors of R
    rays, the carry's own buffers for an update in place) when given."""
    if h.normal.device.type == "cpu":
        return shade_bounce_plain(data, meta, cset, carry, h, occ, first,
                                  relaxed)
    nl = meta.n_lights
    return kernels.shade_bounce(
        carry, (h.hit, h.normal, h.mat, h.point, h.offset), occ,
        (data.mat_ambient, data.mat_diffuse, data.mat_specular,
         data.mat_mirror, data.mat_phong, data.mat_is_mirror),
        data.light_pos[:nl], data.light_int[:nl], data.ambient_light,
        data.background, cset.sph_dat, _n_small(cset), first, relaxed,
        shade.RELEVANT_COS, shade.RAD_TO_DEG, shade.SPEC_GATE_DEG, out=out)


def shade_bounce_plain(data, meta, cset: ClusterSet, carry, h, occ,
                       first: bool, relaxed: bool = False):
    """Plain PyTorch version of :func:`shade_bounce`: the occlusion routes'
    small-sphere test (``_small_sphere_test_multi``), then ``shade.bounce``
    on those bits."""
    if occ is not None and _n_small(cset):
        lps = data.light_pos[:meta.n_lights].reshape(-1)
        occ = occ | _small_sphere_test_multi(cset, h.offset, lps, relaxed)
    return shade.bounce(data, meta, carry, h, first, occ=occ)


@torch.no_grad()
def cluster_shadow(cset: ClusterSet, planes, origin, dirs, light_pos,
                   active=None, relaxed: bool = False,
                   small_spheres: bool = True):
    """Occlusion of the segments origin -> light_pos (t < 1) for ONE light;
    ``dirs`` is the unnormalized segment light_pos - origin (it shapes the
    tile shortlists; the kernel tests origins against ``planes``).
    ``small_spheres`` False leaves out the dense test of a scene's 1 to
    SMALL_SPH spheres (:func:`shade_bounce` makes it)."""
    r, origin, dirs, active = _pad_rays(origin.detach().contiguous(),
                                        dirs.detach().contiguous(), active)
    ones = torch.ones((origin.shape[0],), device=origin.device)
    thit, shit = _cluster_masks(cset, origin, dirs, active, ones)
    lists = [x[None] for x in _lists(thit, shit)]
    lp = light_pos.detach().to(torch.float32).reshape(3).contiguous()
    found = kernels.shadow(*lists, lp, origin, planes[None], cset.sph_dat,
                           relaxed)
    occ = (found & 1) != 0
    if small_spheres and 0 < cset.n_sph <= SMALL_SPH:
        occ = occ | _small_sphere_occluded(cset, origin, dirs, relaxed)
    return occ[:r]


@torch.no_grad()
def cluster_shadow_multi(cset: ClusterSet, planes_list, origin, light_pos,
                         active_per_light, relaxed: bool = False,
                         small_spheres: bool = True):
    """Occlusion toward ALL lights in ONE kernel launch: light_pos (L, 3),
    active_per_light (R, L) bool; returns (R, L) bool, per light equal to
    :func:`cluster_shadow` (``small_spheres`` as there)."""
    nl = len(planes_list)
    lp = light_pos.detach().to(torch.float32).reshape(-1).contiguous()
    origin = origin.detach().contiguous()
    acts = [active_per_light[:, l] for l in range(nl)]
    r, origin, _, *acts = _pad_rays(origin, origin, *acts)
    ones = torch.ones((origin.shape[0],), device=origin.device)
    per_light = []
    for l in range(nl):
        dirs_l = lp[3 * l:3 * l + 3][None] - origin
        per_light.append(_lists(*_cluster_masks(cset, origin, dirs_l,
                                                acts[l], ones)))
    lists = [torch.stack(x) for x in zip(*per_light)]
    found = kernels.shadow(*lists, lp, origin, torch.stack(planes_list),
                           cset.sph_dat, relaxed)
    occ = torch.stack([(found >> l) & 1 for l in range(nl)], dim=1) != 0
    if small_spheres and 0 < cset.n_sph <= SMALL_SPH:
        occ = occ | _small_sphere_test_multi(cset, origin, lp, relaxed)
    return occ[:r]


@torch.no_grad()
def cluster_any(cset: ClusterSet, origin, dirs, t_max, active=None,
                bfc: bool = False, relaxed: bool = False,
                small_spheres: bool = True):
    """(R,) bool: some accepted hit with t < t_max on origin + t dirs (the
    ``any_hit`` kernel; shadow segments pass t_max 1).  ``origin``: (3,)
    or (R, 3); ``t_max``: (R,); ``active`` (R,) bool marks the lanes whose
    result is read (it shapes the shortlists); ``small_spheres`` as in
    :func:`cluster_shadow`."""
    dirs = dirs.detach().contiguous()
    origin = origin.detach().expand(dirs.shape).contiguous()
    r, origin, dirs, active, t_max = _pad_rays(origin, dirs, active,
                                               t_max.detach())
    t_max = t_max.to(torch.float32).contiguous()
    thit, shit = _cluster_masks(cset, origin, dirs, active, t_max)
    found = kernels.any_hit(*_lists(thit, shit), origin, dirs, t_max,
                            cset.tri_dat, cset.sph_dat, bfc, relaxed)
    occ = found != 0
    if small_spheres and 0 < cset.n_sph <= SMALL_SPH:
        occ = occ | _small_sphere_occluded(cset, origin, dirs, relaxed,
                                           t_max[:, None])
    return occ[:r]
