"""The hand-written CUDA kernels (the cluster engine's and the jitter
draw): wrappers, plain PyTorch versions and launch counts.

=============  ===========================  ==============================
wrapper        CUDA source                  replaces (raytracer_tpu/ops/
                                            cluster_trace.py)
=============  ===========================  ==============================
ray_mask       csrc/ray_mask.cu             _ray_mask_kernel (:305)
ray_mask_hier  csrc/ray_mask.cu             _ray_mask_kernel_hier (:242)
compact        csrc/compact.cu              no Pallas kernel: XLA's
                                            lax.top_k and bit packing in
                                            _compact
closest        csrc/closest.cu              _closest_kernel (:720), shared
                                            origin and per-ray origin
shadow         csrc/shadow.cu               _shadow_kernel (:982) and
                                            _shadow_kernel_ml (:1135)
any_hit        csrc/any.cu                  _any_kernel (:837)
threefry_      csrc/threefry.cu             no Pallas kernel: XLA's draw
uniform_keyed                               of jax.random.uniform
(threefry_                                  (models/whitted.py:369), its
uniform)                                    key read from device memory
tile_mask      csrc/tile_mask.cu            no Pallas kernel: XLA's fusion
                                            of tile_cluster_mask, the
                                            interval tile test of shared-
                                            origin eye waves
hit_record     csrc/shade.cu                no Pallas kernel: XLA's fusion
                                            of cluster_closest_hit after
                                            its kernel (:1603) and the
                                            shadow mask (ops/shade.py)
shade_bounce   csrc/shade.cu                no Pallas kernel: XLA's fusion
                                            of shade_local, reflection_rays
                                            (ops/shade.py) and _shade's
                                            carry (models/whitted.py)
=============  ===========================  ==============================

Each wrapper dispatches on the device of its inputs: CPU tensors go to
the plain version beside it (``*_plain``), CUDA tensors to the kernel,
and a kernel that does not build or launch raises; nothing falls back.
The plain versions take the same arguments and compute the same
function, visit for visit, in the same IEEE float32 operations (the
kernels are built with ``-fmad=false``), so on the card each kernel
equals its plain version bit for bit.  ``launches`` counts kernel
launches per wrapper (the closest kernel per call shape); the plain
versions do not count.

Visit semantics (shared by kernel and plain version): a tile's triangle
clusters are visited first, then its sphere clusters; each side walks
the tile's compacted id list (front to back by slab entry) when its
count fits ``MAX_TRI_LIST`` / ``MAX_SPH_LIST``, else every cluster whose
bit is set, ascending; with at most ``DENSE_SPH_ROWS`` sphere clusters
in the scene, a tile with any sphere candidate visits every sphere
cluster, ascending.  The closest hit is the lexicographic minimum of
(t, lane, visit), which is what the TPU kernel's lanewise accumulator
and first-lane argmin give.

The forward bounce epilogue (``hit_record``, ``shade_bounce``) runs one
thread a ray, and its wrappers take CUDA tensors only: the scene-level
entry points ``cluster_trace.hit_record`` and ``shade_bounce`` send CPU
tensors to their plain versions there (``slot_hits``, ``shade.bounce``),
which the kernels follow op for op, summing in the order PyTorch's CUDA
reductions do.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch import backend

TILE = 128           # rays per tile (one CUDA block)
CLUSTER = 128        # primitive slots per cluster
MAX_TRI_LIST = 48    # list capacity before the bitmask fallback
MAX_SPH_LIST = 8
DENSE_SPH_ROWS = 8   # scenes with <= this many sphere clusters visit all

launches = {"ray_mask": 0, "ray_mask_hier": 0, "closest_shared": 0,
            "closest": 0, "shadow": 0, "any": 0, "threefry": 0,
            "hit_record": 0, "shade_bounce": 0, "compact": 0,
            "tile_mask": 0}

# tiles per step of the plain versions: bounds their (tiles, 128, 128)
# and (tiles, 128, C) temporaries
_PLAIN_PAIRS = 1 << 23

_INF = float("inf")
BIG = 1e18           # finite reciprocal sentinel: no inf*0 NaN in slab tests


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# launch plumbing
# ---------------------------------------------------------------------------

def _check(name: str, x: torch.Tensor, dtype, shape, device,
           rows: bool = False, layout: bool = True) -> None:
    """Device, dtype, shape and a contiguous layout; with ``rows`` only a
    unit column stride (a matrix's rows may lie apart); without
    ``layout`` any strides."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not layout:
        return
    if rows and x.shape[1] > 1 and x.stride(1) != 1:
        raise ValueError(f"{name} must have unit column stride")
    if not rows and not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(name: str, counter: str, device: torch.device, *args) -> None:
    """Call C entry ``rt_<name>`` on the current stream of ``device``
    (tensors pass as data pointers, floats as floats), raise on its CUDA
    error code, and count the launch under ``counter``."""
    lib = backend.kernels()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        c_args = [a.data_ptr() if isinstance(a, torch.Tensor)
                  else a if isinstance(a, float) else int(a) for a in args]
        rc = getattr(lib, "rt_" + name)(*c_args, stream)
    backend.check(rc, name)
    launches[counter] += 1


def _chunks(nt: int, per_tile: int):
    step = max(1, _PLAIN_PAIRS // max(1, per_tile))
    for a in range(0, nt, step):
        yield a, min(a + step, nt)


def _visit_table(words, ids, counts, n_clusters: int, max_list: int,
                 a: int, e: int) -> torch.Tensor:
    """(e - a, V) int64 cluster ids in visit order for tiles [a, e), -1
    past a tile's last visit: the list when count <= max_list, else the
    set bits of the tile's bitmask, ascending."""
    nt = counts.shape[0]
    cnt = counts[a:e].long()
    pos = torch.arange(max_list, device=cnt.device)
    lst = ids.view(nt, max_list)[a:e].long()
    lst = torch.where(pos[None] < cnt[:, None], lst, -1)
    over = cnt > max_list
    if bool(over.any()):
        wpt = words.shape[0] // nt
        shift = torch.arange(32, dtype=torch.int32, device=cnt.device)
        bits = (words.view(nt, wpt)[a:e, :, None] >> shift) & 1
        bits = bits.reshape(e - a, wpt * 32)[:, :n_clusters] != 0
        cid = torch.arange(n_clusters, device=cnt.device)
        asc = torch.where(bits, cid, n_clusters).sort(dim=1).values
        asc = torch.where(asc < n_clusters, asc, -1)
        width = max(max_list, n_clusters)
        lst = torch.nn.functional.pad(lst, (0, width - max_list), value=-1)
        asc = torch.nn.functional.pad(asc, (0, width - n_clusters), value=-1)
        lst = torch.where(over[:, None], asc, lst)
    n_vis = int(torch.clamp(cnt, max=lst.shape[1]).max()) if e > a else 0
    return lst[:, :n_vis]


def _dense_table(sc, cs: int, a: int, e: int) -> torch.Tensor:
    """Every sphere cluster, ascending, for tiles with a sphere candidate."""
    cid = torch.arange(cs, device=sc.device)
    return torch.where((sc[a:e] != 0)[:, None], cid[None], -1)


def _gather(dat: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(rows, n, 1, CLUSTER) columns of cluster k per tile (k >= 0)."""
    cols = k.clamp(min=0)[:, None] * CLUSTER + torch.arange(
        CLUSTER, device=k.device)
    return dat[:, cols][:, :, None, :]


# ---------------------------------------------------------------------------
# per-pair tests: the float32 operation order of the Pallas kernels
# (cluster_trace.py:520-568, 621-644, 1031-1035)
# ---------------------------------------------------------------------------

def _tri_test(r, ox, oy, oz, dx, dy, dz, bfc: bool):
    nx, ny, nz, w1x, w1y, w1z, w2x, w2y, w2z, naa, w1aa, w2aa = r
    nd = dx * nx + dy * ny + dz * nz
    no = ox * nx + oy * ny + oz * nz
    t = (naa - no) / nd
    beta = (ox * w1x + oy * w1y + oz * w1z) + t * (dx * w1x + dy * w1y + dz * w1z) - w1aa
    gamma = (ox * w2x + oy * w2y + oz * w2z) + t * (dx * w2x + dy * w2y + dz * w2z) - w2aa
    alpha = 1.0 - beta - gamma
    # all-zero padding rows give t = 0/0 = NaN: every comparison is False
    ok = (alpha >= 0.0) & (beta >= 0.0) & (gamma >= 0.0) & (t >= 0.0)
    if bfc:
        ok = ok & (nd < 0.0)
    return t, ok


def _sph_terms(r, ox, oy, oz, dx, dy, dz):
    cx, cy, cz, rad = r
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    a_q = dx * dx + dy * dy + dz * dz
    b_q = 2.0 * (dx * ocx + dy * ocy + dz * ocz)
    c_q = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
    disc = b_q * b_q - 4.0 * a_q * c_q
    return rad, a_q, b_q, c_q, disc


def _sph_test(r, ox, oy, oz, dx, dy, dz):
    """Smaller root even when negative (the reference's quirk); the t2 < 0
    test is the sign test (sq - b) < 0, division by 2a > 0 kept out."""
    rad, a_q, b_q, _, disc = _sph_terms(r, ox, oy, oz, dx, dy, dz)
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t1 = (-b_q - sq) / (2.0 * a_q)
    ok = (disc >= 0.0) & ~((t1 < 0.0) & ((sq - b_q) < 0.0)) & (rad > 0.0)
    return t1, ok


def _sph_occluded(r, ox, oy, oz, dx, dy, dz, relaxed: bool, t_max=1.0):
    """Any hit with t < t_max on the ray o + t d (t_max 1: the segment
    o -> o + d)."""
    if not relaxed:
        t1, ok = _sph_test(r, ox, oy, oz, dx, dy, dz)
        return ok & (t1 < t_max)
    # sqrt/div-free sign tests (--relaxed-parity); with t_max = 1 the
    # product 2a * t_max is exact, the plane kernel's 2a + b
    rad, a_q, b_q, c_q, disc = _sph_terms(r, ox, oy, oz, dx, dy, dz)
    u = 2.0 * a_q * t_max + b_q
    return ((rad > 0.0) & (disc >= 0.0) & ((b_q <= 0.0) | (c_q <= 0.0))
            & ((u > 0.0) | (disc > u * u)))


def _plane_min(r, ox, oy, oz):
    u0 = ox * r[0] + (oy * r[1] + (oz * r[2] + r[3]))
    v1 = ox * r[4] + (oy * r[5] + (oz * r[6] + r[7]))
    v2 = ox * r[8] + (oy * r[9] + (oz * r[10] + r[11]))
    v3 = ox * r[12] + (oy * r[13] + (oz * r[14] + r[15]))
    return torch.minimum(torch.minimum(u0, v1), torch.minimum(v2, v3))


# ---------------------------------------------------------------------------
# ray_mask: exact per-ray slab test of every ray against every cluster box
# ---------------------------------------------------------------------------

def ray_mask(act: torch.Tensor, box: torch.Tensor, bundle: torch.Tensor):
    """(hit (nt, C) i32, ent (nt, C) f32): does any ray of tile i cross
    cluster box c within its t window, and the least slab entry over those
    rays (+inf when none).

    act: (nt,) i32, 0 for tiles without an active ray (written 0 / +inf).
    box: (8, C) f32 rows [cmin xyz, unused, cmax xyz, unused].
    bundle: (8, nt*128) f32 rows [o*inv (3), t_hi, inv (3), unused], with
    inv the clamped reciprocal direction and t_hi -inf on inactive rays.
    """
    if bundle.device.type == "cpu":
        return ray_mask_plain(act, box, bundle)
    nt, c, dev = act.shape[0], box.shape[1], bundle.device
    _check("act", act, torch.int32, (nt,), dev)
    _check("box", box, torch.float32, (8, c), dev)
    _check("bundle", bundle, torch.float32, (8, nt * TILE), dev)
    hit = torch.empty((nt, c), dtype=torch.int32, device=dev)
    ent = torch.empty((nt, c), dtype=torch.float32, device=dev)
    _launch("ray_mask", "ray_mask", dev, act, box, bundle, hit, ent, nt, c, nt * TILE)
    return hit, ent


def ray_mask_plain(act: torch.Tensor, box: torch.Tensor, bundle: torch.Tensor):
    """Plain PyTorch version of :func:`ray_mask`."""
    nt, c = act.shape[0], box.shape[1]
    hit = torch.zeros((nt, c), dtype=torch.int32, device=bundle.device)
    ent = torch.full((nt, c), _INF, dtype=torch.float32, device=bundle.device)
    bx = box[:, None, None, :]
    b = bundle.view(8, nt, TILE)
    for a, e in _chunks(nt, TILE * c):
        oix, oiy, oiz, thi, ix, iy, iz = b[:7, a:e, :, None]
        t1 = ix * bx[0] - oix
        t2 = ix * bx[4] - oix
        nx, fx = torch.minimum(t1, t2), torch.maximum(t1, t2)
        t1 = iy * bx[1] - oiy
        t2 = iy * bx[5] - oiy
        ny, fy = torch.minimum(t1, t2), torch.maximum(t1, t2)
        t1 = iz * bx[2] - oiz
        t2 = iz * bx[6] - oiz
        nz, fz = torch.minimum(t1, t2), torch.maximum(t1, t2)
        entry = torch.maximum(nx, torch.maximum(ny, nz))
        exit_ = torch.minimum(fx, torch.minimum(fy, fz))
        pair = (entry <= exit_) & (exit_ >= 0.0) & (entry <= thi)
        live = (act[a:e] != 0)[:, None]
        hit[a:e] = (pair.any(1) & live).to(torch.int32)
        ent[a:e] = torch.where(
            live, torch.where(pair, entry, _INF).amin(1), _INF)
    return hit, ent


def ray_mask_hier(act: torch.Tensor, sup: torch.Tensor, box: torch.Tensor,
                  bundle: torch.Tensor):
    """:func:`ray_mask` with each 128-cluster chunk j of tile i gated by
    the coarse bit ``sup[i * S + j]`` (S = ceil(C / 128) superclusters):
    a chunk whose bit is 0 is written 0 / +inf untested.  With ``sup`` from
    the slab test against dilated unions of each chunk's boxes (coarse
    miss implies fine miss) the result equals :func:`ray_mask`."""
    if bundle.device.type == "cpu":
        return ray_mask_hier_plain(act, sup, box, bundle)
    nt, c, dev = act.shape[0], box.shape[1], bundle.device
    s = -(-c // CLUSTER)
    _check("act", act, torch.int32, (nt,), dev)
    _check("sup", sup, torch.int32, (nt * s,), dev)
    _check("box", box, torch.float32, (8, c), dev)
    _check("bundle", bundle, torch.float32, (8, nt * TILE), dev)
    hit = torch.empty((nt, c), dtype=torch.int32, device=dev)
    ent = torch.empty((nt, c), dtype=torch.float32, device=dev)
    _launch("ray_mask_hier", "ray_mask_hier", dev, act, sup, box, bundle, hit,
            ent, nt, c, nt * TILE)
    return hit, ent


def ray_mask_hier_plain(act: torch.Tensor, sup: torch.Tensor,
                        box: torch.Tensor, bundle: torch.Tensor):
    """Plain PyTorch version of :func:`ray_mask_hier`: the flat plain mask
    chunk by chunk, with tiles whose coarse bit is 0 taken as inactive."""
    nt, c = act.shape[0], box.shape[1]
    s = -(-c // CLUSTER)
    gate = sup.view(nt, s)
    parts = [ray_mask_plain(act * gate[:, j], box[:, j * CLUSTER:(j + 1) * CLUSTER],
                            bundle) for j in range(s)]
    return (torch.cat([p[0] for p in parts], 1),
            torch.cat([p[1] for p in parts], 1))


# ---------------------------------------------------------------------------
# tile_mask: the interval tile test of shared-origin eye waves
# ---------------------------------------------------------------------------

def tile_mask(origin, dirs, active, cmin, cmax, t_hi, tile: int,
              subsplit: int = 1):
    """(hit (nt, C) bool, entry lower bound (nt, C) f32), nt = R // tile:
    could any ray of the tile hit the cluster box?  Interval arithmetic
    over the tile's origin and direction boxes (conservative; near-tight
    for the coherent frusta of shared-origin eye tiles).

    origin, dirs: (R, 3) f32; active: (R,) bool or None; cmin, cmax: (C,
    3) f32 cluster boxes (NaN rows never hit); t_hi: (R,) f32 upper bound
    of the useful t per ray, or None (closest-hit waves).  With
    ``subsplit`` > 1 each tile is tested as that many sub-intervals of
    consecutive rays whose results are merged (hit: any; entry: the least
    over the sub-intervals that hit), tighter for tiles whose origins
    straddle depth discontinuities.  Equal to the plain version: hit
    everywhere, entry with NaN at the same places and equal elsewhere (a
    zero may carry the other sign; csrc/tile_mask.cu's four-product path
    gives the eight products' values)."""
    r, c, dev = dirs.shape[0], cmin.shape[0], dirs.device
    for name, x, dtype, shape in (
            ("origin", origin, torch.float32, (r, 3)),
            ("dirs", dirs, torch.float32, (r, 3)),
            ("active", active, torch.bool, (r,)),
            ("cmin", cmin, torch.float32, (c, 3)),
            ("cmax", cmax, torch.float32, (c, 3)),
            ("t_hi", t_hi, torch.float32, (r,))):
        if x is not None:
            _check(name, x, dtype, shape, dev, layout=dev.type != "cpu")
    if tile < 1 or subsplit < 1 or tile % subsplit or r % tile:
        raise ValueError(f"{r} rays do not split into tiles of {tile} rays "
                         f"and {subsplit} sub-intervals")
    if dev.type == "cpu":
        return tile_mask_plain(origin, dirs, active, cmin, cmax, t_hi, tile,
                               subsplit)
    nt = r // tile
    hit = torch.empty((nt, c), dtype=torch.bool, device=dev)
    entry = torch.empty((nt, c), dtype=torch.float32, device=dev)
    _launch("tile_mask", "tile_mask", dev, origin, dirs,
            0 if active is None else active, cmin, cmax,
            0 if t_hi is None else t_hi, hit, entry, nt, c, tile, subsplit)
    return hit, entry


def _interval_mul(alo, ahi, blo, bhi):
    p1, p2, p3, p4 = alo * blo, alo * bhi, ahi * blo, ahi * bhi
    lo = torch.minimum(torch.minimum(p1, p2), torch.minimum(p3, p4))
    hi = torch.maximum(torch.maximum(p1, p2), torch.maximum(p3, p4))
    return lo, hi


def tile_mask_plain(origin, dirs, active, cmin, cmax, t_hi, tile: int,
                    subsplit: int = 1):
    """Plain PyTorch version of :func:`tile_mask`: dense (tiles, C, 3)
    interval products, minima and maxima."""
    r = dirs.shape[0]
    nt_out = r // tile
    tile //= subsplit
    nt = r // tile
    o = origin.reshape(nt, tile, 3)
    d = dirs.reshape(nt, tile, 3)
    if active is None:
        o_lo, o_hi = o.amin(1), o.amax(1)
        d_lo, d_hi = d.amin(1), d.amax(1)
        none_active = None
        cap = None if t_hi is None else t_hi.reshape(nt, tile).amax(1)
    else:
        act = active.reshape(nt, tile, 1)
        o_lo = torch.where(act, o, _INF).amin(1)
        o_hi = torch.where(act, o, -_INF).amax(1)
        d_lo = torch.where(act, d, _INF).amin(1)
        d_hi = torch.where(act, d, -_INF).amax(1)
        none_active = ~active.reshape(nt, tile).any(1, keepdim=True)
        # a fully-inactive tile gets a degenerate point interval at 0
        o_lo = torch.where(none_active, 0.0, o_lo)
        o_hi = torch.where(none_active, 0.0, o_hi)
        d_lo = torch.where(none_active, 1.0, d_lo)
        d_hi = torch.where(none_active, 1.0, d_hi)
        cap = None
        if t_hi is not None:
            cap = torch.where(active.reshape(nt, tile), t_hi.reshape(nt, tile),
                              -_INF).amax(1)
            cap = torch.where(none_active[:, 0], 0.0, cap)

    crosses = (d_lo <= 0.0) & (d_hi >= 0.0)
    i_lo = torch.where(crosses, -BIG, 1.0 / d_hi)
    i_hi = torch.where(crosses, BIG, 1.0 / d_lo)

    n1_lo = cmin[None] - o_hi[:, None]
    n1_hi = cmin[None] - o_lo[:, None]
    n2_lo = cmax[None] - o_hi[:, None]
    n2_hi = cmax[None] - o_lo[:, None]
    il, ih = i_lo[:, None], i_hi[:, None]
    t1_lo, t1_hi = _interval_mul(n1_lo, n1_hi, il, ih)
    t2_lo, t2_hi = _interval_mul(n2_lo, n2_hi, il, ih)
    entry_lo = torch.minimum(t1_lo, t2_lo).amax(-1)   # (nt, C)
    exit_hi = torch.maximum(t1_hi, t2_hi).amin(-1)
    hit = (entry_lo <= exit_hi) & (exit_hi >= 0.0)
    if cap is not None:
        hit &= entry_lo <= cap[:, None]
    if none_active is not None:
        hit &= ~none_active
    if subsplit > 1:
        c = hit.shape[1]
        hit_s = hit.reshape(nt_out, subsplit, c)
        entry_s = entry_lo.reshape(nt_out, subsplit, c)
        entry_lo = torch.where(hit_s, entry_s, _INF).amin(1)
        hit = hit_s.any(1)
    return hit, entry_lo


# ---------------------------------------------------------------------------
# compact: a tile mask's shortlists (what the visiting kernels read)
# ---------------------------------------------------------------------------

def compact(hit: torch.Tensor, entry: torch.Tensor, max_list: int,
            tally=None):
    """(words (nt*W,) i32, ids (nt*max_list,) i32, elist (nt*max_list,)
    f32, counts (nt,) i32) of a tile mask ``hit`` (nt, C) bool and its slab
    entries ``entry`` (nt, C) f32, W = ceil(C / 32): bit b of word w is
    column 32w + b; each tile's first max_list hit columns by ascending
    entry (equal entries: the lower column first, -0 as +0) and their
    entries; the unclamped hit count.  Equal to the plain version on words
    and counts, and on ids and elist below min(count, max_list), which is
    all a visiting kernel reads (past it the kernel writes 0 and +inf).
    Rows need only a unit column stride.  ``tally`` ((2,) int64 on the
    device, or None): adds [the tiles with a hit column, those whose
    count passes max_list] to it."""
    if hit.device.type == "cpu":
        return compact_plain(hit, entry, max_list, tally)
    nt, c = hit.shape
    dev = hit.device
    _check("hit", hit, torch.bool, (nt, c), dev, rows=True)
    _check("entry", entry, torch.float32, (nt, c), dev, rows=True)
    if tally is not None:
        _check("tally", tally, torch.int64, (2,), dev)
    if not 1 <= max_list <= 64:
        raise ValueError(f"max_list {max_list} is outside [1, 64]")
    words = torch.empty((nt * -(-c // 32),), dtype=torch.int32, device=dev)
    ids = torch.empty((nt * max_list,), dtype=torch.int32, device=dev)
    elist = torch.empty((nt * max_list,), dtype=torch.float32, device=dev)
    counts = torch.empty((nt,), dtype=torch.int32, device=dev)
    _launch("compact", "compact", dev, hit, hit.stride(0), entry,
            entry.stride(0), words, ids, elist, counts,
            0 if tally is None else tally, nt, c, max_list)
    return words, ids, elist, counts


def compact_plain(hit: torch.Tensor, entry: torch.Tensor, max_list: int,
                  tally=None):
    """Plain PyTorch version of :func:`compact`: a stable descending sort
    of -entry over every column (ties keep the lower column id, like
    ``lax.top_k``) and the bitmask summed in int64."""
    nt, c = hit.shape
    dev = hit.device
    counts = hit.sum(1).to(torch.int32)
    if tally is not None:
        tally.add_(torch.stack([(counts > 0).sum(),
                                (counts > max_list).sum()]))
    k = min(max_list, c)
    keys = torch.where(hit, -entry, -_INF)
    vals, ids = torch.sort(keys, dim=1, descending=True, stable=True)
    ids = ids[:, :k].to(torch.int32)
    elist = -vals[:, :k]
    if k < max_list:
        ids = torch.nn.functional.pad(ids, (0, max_list - k))
        elist = torch.nn.functional.pad(elist, (0, max_list - k), value=_INF)
    w = -(-c // 32)
    hp = torch.nn.functional.pad(hit, (0, w * 32 - c))
    weights = torch.ones((), dtype=torch.int64, device=dev) << torch.arange(
        32, dtype=torch.int64, device=dev)
    words = (hp.reshape(nt, w, 32).to(torch.int64) * weights).sum(-1)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return (words.reshape(-1).to(torch.int32), ids.reshape(-1).contiguous(),
            elist.reshape(-1), counts)


# ---------------------------------------------------------------------------
# closest: nearest triangle/sphere hit over each tile's shortlists
# ---------------------------------------------------------------------------

def closest(tw, tl, tc, sw, sl, sc, origin, dirs, tri_dat, sph_dat,
            bfc: bool = False):
    """(t (R,) f32, slot (R,) i32) of each ray's closest hit; (inf, -1) on
    a miss.  Slots: k*128 + j for triangle cluster k, Pt + k*128 + j for
    sphere cluster k.

    tw/sw: (nt*W,) i32 candidate bitmasks; tl: (nt*48,) / sl: (nt*8,) i32
    front-to-back id lists; tc/sc: (nt,) i32 candidate counts (unclamped).
    origin: (3,) f32 for a shared origin (eye rays) or (R, 3); dirs: (R, 3).
    tri_dat: (12, Pt), sph_dat: (4, Ps) f32 cluster tables.
    """
    if dirs.device.type == "cpu":
        return closest_plain(tw, tl, tc, sw, sl, sc, origin, dirs, tri_dat,
                             sph_dat, bfc)
    dev, r = dirs.device, dirs.shape[0]
    nt, pt, ps = r // TILE, tri_dat.shape[1], sph_dat.shape[1]
    ct, cs = pt // CLUSTER, ps // CLUSTER
    wt, ws = tw.shape[0] // max(nt, 1), sw.shape[0] // max(nt, 1)
    shared = origin.dim() == 1
    for name, x, shape in (("tw", tw, (nt * wt,)), ("tl", tl, (nt * MAX_TRI_LIST,)),
                           ("tc", tc, (nt,)), ("sw", sw, (nt * ws,)),
                           ("sl", sl, (nt * MAX_SPH_LIST,)), ("sc", sc, (nt,))):
        _check(name, x, torch.int32, shape, dev)
    _check("origin", origin, torch.float32, (3,) if shared else (r, 3), dev)
    _check("dirs", dirs, torch.float32, (nt * TILE, 3), dev)
    _check("tri_dat", tri_dat, torch.float32, (12, ct * CLUSTER), dev)
    _check("sph_dat", sph_dat, torch.float32, (4, cs * CLUSTER), dev)
    t = torch.empty((r,), dtype=torch.float32, device=dev)
    slot = torch.empty((r,), dtype=torch.int32, device=dev)
    _launch("closest", "closest_shared" if shared else "closest", dev, tw, tl, tc, sw, sl, sc, origin, dirs, tri_dat,
            sph_dat, t, slot, nt, ct, cs, pt, ps, wt, ws, int(shared), int(bfc))
    return t, slot


def closest_plain(tw, tl, tc, sw, sl, sc, origin, dirs, tri_dat, sph_dat,
                  bfc: bool = False):
    """Plain PyTorch version of :func:`closest`: vectorised over tiles,
    one step per visit index."""
    dev, r = dirs.device, dirs.shape[0]
    nt, pt = r // TILE, tri_dat.shape[1]
    ct, cs = pt // CLUSTER, sph_dat.shape[1] // CLUSTER
    t_out = torch.full((nt, TILE), _INF, dtype=torch.float32, device=dev)
    s_out = torch.full((nt, TILE), -1, dtype=torch.int32, device=dev)
    d = dirs.view(nt, TILE, 3)
    for a, e in _chunks(nt, TILE * CLUSTER):
        n = e - a
        dx, dy, dz = d[a:e, :, None, 0], d[a:e, :, None, 1], d[a:e, :, None, 2]
        if origin.dim() == 1:
            ox, oy, oz = origin[0], origin[1], origin[2]
        else:
            o = origin.view(nt, TILE, 3)[a:e]
            ox, oy, oz = o[:, :, None, 0], o[:, :, None, 1], o[:, :, None, 2]
        bt = torch.full((n, TILE), _INF, dtype=torch.float32, device=dev)
        bj = torch.full((n, TILE), CLUSTER, dtype=torch.int64, device=dev)
        bk = torch.zeros((n, TILE), dtype=torch.int64, device=dev)
        tri_vis = _visit_table(tw, tl, tc, ct, MAX_TRI_LIST, a, e)
        sph_vis = (_dense_table(sc, cs, a, e) if cs <= DENSE_SPH_ROWS else
                   _visit_table(sw, sl, sc, cs, MAX_SPH_LIST, a, e))
        for vis, dat, k0 in ((tri_vis, tri_dat, 0), (sph_vis, sph_dat, ct)):
            for v in range(vis.shape[1]):
                k = vis[:, v]
                rows = _gather(dat, k)
                if k0 == 0:
                    t, ok = _tri_test(rows, ox, oy, oz, dx, dy, dz, bfc)
                else:
                    t, ok = _sph_test(rows, ox, oy, oz, dx, dy, dz)
                t = torch.where(ok & (k >= 0)[:, None, None], t, _INF)
                tv, jv = t.min(dim=-1)
                upd = (tv < bt) | ((tv == bt) & (jv < bj))
                bt = torch.where(upd, tv, bt)
                bj = torch.where(upd, jv, bj)
                bk = torch.where(upd, (k + k0)[:, None], bk)
        slot = torch.where(bk >= ct, pt + (bk - ct) * CLUSTER + bj,
                           bk * CLUSTER + bj)
        t_out[a:e] = bt
        s_out[a:e] = torch.where(bt < _INF, slot, -1).to(torch.int32)
    return t_out.reshape(r), s_out.reshape(r)


# ---------------------------------------------------------------------------
# shadow: any-hit toward each point light over the tile's shortlists
# ---------------------------------------------------------------------------

def shadow(tw, tl, tc, sw, sl, sc, lps, origin, planes, sph_dat,
           relaxed: bool = False, act=None, tally=None):
    """(R,) i32 bitfield, bit l set iff ray r is active toward light l and
    the segment origin -> light l is occluded (a triangle by the 4-plane
    test, a sphere with t < 1).

    tw, tl, tc, sw, sl, sc: per-light shortlists stacked on a leading
    light axis (as in :func:`closest`); lps: (3*L,) f32 light positions;
    origin: (R, 3) f32; planes: (L, 16, Pt) f32 from
    ``cluster_trace.build_shadow_planes``; sph_dat: (4, Ps) f32.  ``act``
    ((L, R) bool or uint8 of any strides, or None: every ray active): the
    rays whose bit is wanted; the sphere walks test only those not yet
    occluded.
    ``tally`` ((2,) int64 on the device, or None): adds [128 for each
    (tile, light) whose sphere walk runs, that walk's live rays (active
    and not occluded by a triangle) as it starts] to it.
    """
    if origin.device.type == "cpu":
        return shadow_plain(tw, tl, tc, sw, sl, sc, lps, origin, planes,
                            sph_dat, relaxed, act, tally)
    dev, r, nl = origin.device, origin.shape[0], planes.shape[0]
    nt, pt, ps = r // TILE, planes.shape[2], sph_dat.shape[1]
    ct, cs = pt // CLUSTER, ps // CLUSTER
    wt, ws = tw.shape[1] // max(nt, 1), sw.shape[1] // max(nt, 1)
    if not 1 <= nl <= 32:
        raise ValueError(f"{nl} lights: the bitfield holds 1 to 32")
    for name, x, shape in (("tw", tw, (nl, nt * wt)), ("tl", tl, (nl, nt * MAX_TRI_LIST)),
                           ("tc", tc, (nl, nt)), ("sw", sw, (nl, nt * ws)),
                           ("sl", sl, (nl, nt * MAX_SPH_LIST)), ("sc", sc, (nl, nt))):
        _check(name, x, torch.int32, shape, dev)
    _check("lps", lps, torch.float32, (3 * nl,), dev)
    _check("origin", origin, torch.float32, (nt * TILE, 3), dev)
    _check("planes", planes, torch.float32, (nl, 16, ct * CLUSTER), dev)
    _check("sph_dat", sph_dat, torch.float32, (4, cs * CLUSTER), dev)
    if act is not None:
        if act.dtype == torch.bool:
            act = act.view(torch.uint8)
        _check("act", act, torch.uint8, (nl, nt * TILE), dev, layout=False)
    if tally is not None:
        _check("tally", tally, torch.int64, (2,), dev)
    found = torch.empty((r,), dtype=torch.int32, device=dev)
    _launch("shadow", "shadow", dev, tw, tl, tc, sw, sl, sc, lps, origin, planes,
            sph_dat, 0 if act is None else act, found,
            0 if tally is None else tally, nt, nl, ct, cs, pt, ps, wt, ws,
            0 if act is None else act.stride(0),
            0 if act is None else act.stride(1), int(relaxed))
    return found


def shadow_plain(tw, tl, tc, sw, sl, sc, lps, origin, planes, sph_dat,
                 relaxed: bool = False, act=None, tally=None):
    """Plain PyTorch version of :func:`shadow`.  The per-(ray, lane) plane
    accumulator is a running max that propagates NaN, as on the TPU; every
    ray is tested against every visit (the kernel's sphere walks skip only
    rays whose bit cannot change or is not wanted), then ANDed with
    ``act``."""
    dev, r, nl = origin.device, origin.shape[0], planes.shape[0]
    nt, pt = r // TILE, planes.shape[2]
    ct, cs = pt // CLUSTER, sph_dat.shape[1] // CLUSTER
    found = torch.zeros((nt, TILE), dtype=torch.int32, device=dev)
    o = origin.view(nt, TILE, 3)
    want = (torch.ones((nl, nt, TILE), dtype=torch.bool, device=dev)
            if act is None else (act != 0).view(nl, nt, TILE))
    for a, e in _chunks(nt, TILE * CLUSTER):
        ox, oy, oz = o[a:e, :, None, 0], o[a:e, :, None, 1], o[a:e, :, None, 2]
        fnd = torch.zeros((e - a, TILE), dtype=torch.int32, device=dev)
        seg = [(lps[3 * l] - ox, lps[3 * l + 1] - oy, lps[3 * l + 2] - oz)
               for l in range(nl)]
        gate = (sc[:, a:e] != 0).any(0)
        for l in range(nl):
            acc = torch.full((e - a, TILE, CLUSTER), -_INF, device=dev)
            vis = _visit_table(tw[l], tl[l], tc[l], ct, MAX_TRI_LIST, a, e)
            for v in range(vis.shape[1]):
                k = vis[:, v]
                m = _plane_min(_gather(planes[l], k), ox, oy, oz)
                acc = torch.maximum(acc, torch.where((k >= 0)[:, None, None], m, -_INF))
            tri = (acc >= 0.0).any(-1)
            fnd |= tri.to(torch.int32) << l
            if tally is not None:
                walks = sc[l, a:e] != 0 if cs > DENSE_SPH_ROWS else gate
                live = (want[l, a:e] & ~tri).sum(1)
                tally.add_(torch.stack([TILE * walks.sum(),
                                        (live * walks).sum()]))
            if cs > DENSE_SPH_ROWS:
                vis = _visit_table(sw[l], sl[l], sc[l], cs, MAX_SPH_LIST, a, e)
                for v in range(vis.shape[1]):
                    k = vis[:, v]
                    hit = _sph_occluded(_gather(sph_dat, k), ox, oy, oz,
                                        *seg[l], relaxed)
                    fnd |= (hit.any(-1) & (k >= 0)[:, None]).to(torch.int32) << l
        if cs <= DENSE_SPH_ROWS:
            for k in range(cs):
                rows = sph_dat[:, k * CLUSTER:(k + 1) * CLUSTER][:, None, None, :]
                for l in range(nl):
                    hit = _sph_occluded(rows, ox, oy, oz, *seg[l], relaxed)
                    fnd |= (hit.any(-1) & gate[:, None]).to(torch.int32) << l
        found[a:e] = fnd
    if act is not None:
        bits = want.to(torch.int32) << torch.arange(
            nl, dtype=torch.int32, device=dev)[:, None, None]
        found &= bits.sum(0, dtype=torch.int32)
    return found.reshape(r)


# ---------------------------------------------------------------------------
# any_hit: generic segment any-hit over each tile's shortlists
# ---------------------------------------------------------------------------

def any_hit(tw, tl, tc, sw, sl, sc, origin, dirs, t_max, tri_dat, sph_dat,
            bfc: bool = False, relaxed: bool = False):
    """(R,) i32, 1 where some triangle (the closest kernel's test) or
    sphere of the tile's shortlists is hit with t < t_max on the ray
    origin + t dirs.

    Shortlists as in :func:`closest`; origin, dirs: (R, 3) f32; t_max:
    (R,) f32.  Every lane of a listed tile is tested, inactive ones too
    (their t_max makes them whatever it makes them)."""
    if dirs.device.type == "cpu":
        return any_hit_plain(tw, tl, tc, sw, sl, sc, origin, dirs, t_max,
                             tri_dat, sph_dat, bfc, relaxed)
    dev, r = dirs.device, dirs.shape[0]
    nt, pt, ps = r // TILE, tri_dat.shape[1], sph_dat.shape[1]
    ct, cs = pt // CLUSTER, ps // CLUSTER
    wt, ws = tw.shape[0] // max(nt, 1), sw.shape[0] // max(nt, 1)
    for name, x, shape in (("tw", tw, (nt * wt,)), ("tl", tl, (nt * MAX_TRI_LIST,)),
                           ("tc", tc, (nt,)), ("sw", sw, (nt * ws,)),
                           ("sl", sl, (nt * MAX_SPH_LIST,)), ("sc", sc, (nt,))):
        _check(name, x, torch.int32, shape, dev)
    _check("origin", origin, torch.float32, (nt * TILE, 3), dev)
    _check("dirs", dirs, torch.float32, (nt * TILE, 3), dev)
    _check("t_max", t_max, torch.float32, (nt * TILE,), dev)
    _check("tri_dat", tri_dat, torch.float32, (12, ct * CLUSTER), dev)
    _check("sph_dat", sph_dat, torch.float32, (4, cs * CLUSTER), dev)
    found = torch.empty((r,), dtype=torch.int32, device=dev)
    _launch("any", "any", dev, tw, tl, tc, sw, sl, sc, origin, dirs, t_max,
            tri_dat, sph_dat, found, nt, ct, cs, pt, ps, wt, ws, int(bfc),
            int(relaxed))
    return found


def any_hit_plain(tw, tl, tc, sw, sl, sc, origin, dirs, t_max, tri_dat,
                  sph_dat, bfc: bool = False, relaxed: bool = False):
    """Plain PyTorch version of :func:`any_hit`: the closest kernel's visit
    tables, an OR per visit; the all-lanes early exit is left out (it skips
    only visits that cannot change a bit)."""
    dev, r = dirs.device, dirs.shape[0]
    nt, pt = r // TILE, tri_dat.shape[1]
    ct, cs = pt // CLUSTER, sph_dat.shape[1] // CLUSTER
    found = torch.zeros((nt, TILE), dtype=torch.int32, device=dev)
    o, d = origin.view(nt, TILE, 3), dirs.view(nt, TILE, 3)
    tm = t_max.view(nt, TILE, 1)
    for a, e in _chunks(nt, TILE * CLUSTER):
        ox, oy, oz = o[a:e, :, None, 0], o[a:e, :, None, 1], o[a:e, :, None, 2]
        dx, dy, dz = d[a:e, :, None, 0], d[a:e, :, None, 1], d[a:e, :, None, 2]
        tmax = tm[a:e]
        fnd = torch.zeros((e - a, TILE), dtype=torch.bool, device=dev)
        tri_vis = _visit_table(tw, tl, tc, ct, MAX_TRI_LIST, a, e)
        sph_vis = (_dense_table(sc, cs, a, e) if cs <= DENSE_SPH_ROWS else
                   _visit_table(sw, sl, sc, cs, MAX_SPH_LIST, a, e))
        for v in range(tri_vis.shape[1]):
            k = tri_vis[:, v]
            t, ok = _tri_test(_gather(tri_dat, k), ox, oy, oz, dx, dy, dz, bfc)
            fnd |= (ok & (t < tmax)).any(-1) & (k >= 0)[:, None]
        for v in range(sph_vis.shape[1]):
            k = sph_vis[:, v]
            hit = _sph_occluded(_gather(sph_dat, k), ox, oy, oz, dx, dy, dz,
                                relaxed, tmax)
            fnd |= hit.any(-1) & (k >= 0)[:, None]
        found[a:e] = fnd.to(torch.int32)
    return found.reshape(r)


# ---------------------------------------------------------------------------
# threefry_uniform: JAX's threefry2x32 uniform draw
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 with 20 rounds (JAX's ``threefry2x32_p``) of the
    counter words (x0, x1) under ``key`` = (k0, k1): Python ints, or int64
    tensors holding values in [0, 2**32) (every step is masked to 32
    bits).  Returns the two output words."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & _M32
        x1 = (x1 + ks[(g + 2) % 3] + g + 1) & _M32
    return x0, x1


def threefry_uniform(k0: int, k1: int, n: int, lo: float, hi: float,
                     device) -> torch.Tensor:
    """(n,) f32 on ``device``: element i is ``jax.random.uniform``'s draw i
    under the key (k0, k1) in [lo, hi), bit for bit (see the plain
    version).  A CPU device takes the plain version; elsewhere the key is
    written into a (2,) tensor on ``device`` and drawn by
    :func:`threefry_uniform_keyed`."""
    device = torch.device(device)
    if device.type == "cpu":
        return threefry_uniform_plain(k0, k1, n, lo, hi, device)
    # written by fills, the words as their kernels' arguments: nothing waits
    # for the stream, as a copy from host memory can
    key = torch.full((2,), k0 & _M32, dtype=torch.int64, device=device)
    key[1].fill_(k1 & _M32)
    out = torch.empty((n,), dtype=torch.float32, device=device)
    return threefry_uniform_keyed(key, out, lo, hi)


def threefry_uniform_keyed(key: torch.Tensor, out: torch.Tensor, lo: float,
                           hi: float) -> torch.Tensor:
    """``out`` (contiguous f32, any shape) filled with the draw of
    :func:`threefry_uniform` of ``out.numel()`` elements under the key
    words that the (2,) int64 tensor ``key`` holds in their low 32 bits;
    returns ``out``.  The kernel reads the key from device memory, so a
    captured program that calls this replays the draw of whatever key was
    written into ``key`` before the replay, into the same buffer.  A CPU
    ``out`` takes the plain version, a CUDA one the kernel."""
    if out.device.type == "cpu":
        return threefry_uniform_keyed_plain(key, out, lo, hi)
    dev = out.device
    _check("key", key, torch.int64, (2,), dev)
    _check("out", out, torch.float32, out.shape, dev)
    _launch("threefry_uniform", "threefry", dev, key, float(lo), float(hi),
            out, out.numel())
    return out


def threefry_uniform_plain(k0: int, k1: int, n: int, lo: float, hi: float,
                           device="cpu") -> torch.Tensor:
    """Plain PyTorch version of :func:`threefry_uniform`: the keyed plain
    version under a key tensor of (k0, k1) on ``device``."""
    key = torch.tensor([k0 & _M32, k1 & _M32], dtype=torch.int64,
                       device=device)
    out = torch.empty((n,), dtype=torch.float32, device=device)
    return threefry_uniform_keyed_plain(key, out, lo, hi)


def threefry_uniform_keyed_plain(key: torch.Tensor, out: torch.Tensor,
                                 lo: float, hi: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`threefry_uniform_keyed`: int64 tensor
    ops on the key tensor's words (read on its device, nothing goes to the
    host), masked to 32 bits.  The counter of element i is (i >> 32, i &
    M); its bits are the xor of the two output words, their top 23 bits the
    mantissa of a float in [1, 2), less 1, then scaled to [lo, hi) in f32
    and clamped below at lo (``jax.random.uniform``'s steps), written into
    ``out``."""
    k = key & _M32
    i = torch.arange(out.numel(), dtype=torch.int64, device=out.device)
    x0, x1 = threefry2x32((k[0], k[1]), i >> 32, i & _M32)
    bits = ((x0 ^ x1) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    lo_t = torch.tensor(lo, dtype=torch.float32, device=out.device)
    hi_t = torch.tensor(hi, dtype=torch.float32, device=out.device)
    return out.copy_(torch.maximum(lo_t, f * (hi_t - lo_t) + lo_t)
                     .view(out.shape))


# ---------------------------------------------------------------------------
# hit_record, shade_bounce: the cluster engine's forward bounce epilogue,
# before and after the occlusion pass (on the card only: their plain
# versions, on the scene's arrays, are cluster_trace.hit_record_plain and
# shade_bounce_plain)
# ---------------------------------------------------------------------------

def _cuda(name: str, x: torch.Tensor) -> torch.device:
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on the card; {x.device} tensors take "
                         "its plain version (ops/cluster_trace.py)")
    return x.device


def hit_record(t, slot, origin, dirs, active, slot_pack, sph_dat, light_pos,
               n_small: int, eps: float, relevant_cos: float):
    """(hit (R,) bool, normal (R, 3), mat (R,) int64, point (R, 3), offset
    (R, 3), mask (R, L) bool) of rays ``origin`` ((3,) shared or (R, 3)) +
    t ``dirs`` (R, 3) from the closest kernel's (t, slot) ((R_pad,),
    padded to whole tiles): the first ``n_small`` spheres of ``sph_dat``
    (4, Ps) tested densely and merged, the hit's ``slot_pack`` (Pt + Ps,
    8) row, its hit ANDed with ``active`` (R,) bool, and the shadow
    pass's mask hit & (cos_theta >= relevant_cos) toward each of
    ``light_pos`` (L, 3)."""
    dev = _cuda("hit_record", dirs)
    r, nl = dirs.shape[0], light_pos.shape[0]
    rp = -(-r // TILE) * TILE
    pt, ps = slot_pack.shape[0] - sph_dat.shape[1], sph_dat.shape[1]
    shared = origin.dim() == 1
    _check("t", t, torch.float32, (rp,), dev)
    _check("slot", slot, torch.int32, (rp,), dev)
    _check("origin", origin, torch.float32, (3,) if shared else (r, 3), dev)
    _check("dirs", dirs, torch.float32, (r, 3), dev)
    _check("active", active, torch.bool, (r,), dev)
    _check("slot_pack", slot_pack, torch.float32, (pt + ps, 8), dev)
    _check("sph_dat", sph_dat, torch.float32, (4, ps), dev)
    _check("light_pos", light_pos, torch.float32, (nl, 3), dev)
    if slot_pack.data_ptr() % 16:
        raise ValueError("slot_pack must be 16-byte aligned (float4 rows)")
    f32 = dict(dtype=torch.float32, device=dev)
    out = (torch.empty((r,), dtype=torch.bool, device=dev),
           torch.empty((r, 3), **f32),
           torch.empty((r,), dtype=torch.int64, device=dev),
           torch.empty((r, 3), **f32), torch.empty((r, 3), **f32),
           torch.empty((r, nl), dtype=torch.bool, device=dev))
    _launch("hit_record", "hit_record", dev, t, slot, origin, dirs, active,
            slot_pack, sph_dat, light_pos, *out, r, pt, ps, n_small, nl,
            int(shared), float(eps), float(relevant_cos))
    return out


def shade_bounce(carry, record, occ, materials, light_pos, light_int,
                 ambient_light, background, sph_dat, n_small: int,
                 first: bool, relaxed: bool, relevant_cos: float,
                 rad_to_deg: float, gate_deg: float, out=None):
    """The next (color, throughput, active, cur_org, cur_dir) of a forward
    bounce's ``carry`` (the same five; ``cur_org`` may be the shared (3,)
    origin) from its ``record`` (hit, normal, mat, point, offset of
    :func:`hit_record`) and ``occ`` (R, L) bool, the occlusion pass's bits
    (None without lights), ORed with the segment test of the first
    ``n_small`` spheres of ``sph_dat``: the background of a ``first``
    bounce's misses, ambient and Blinn-Phong from ``materials`` (ambient,
    diffuse, specular, mirror (M, 3); phong (M,); is_mirror (M,) bool),
    the lights (L, 3) and ``ambient_light`` (3,), color += throughput *
    local, the mirror reflection and the carry.  Writes ``out`` (five
    tensors of R rays; the carry's own buffers for an update in place,
    where an inactive lane returns after its flag) when given, else new
    tensors; returns them."""
    color, throughput, active, cur_org, cur_dir = carry
    hit, normal, mat, point, offset = record
    ambient, diffuse, specular, mirror, phong, is_mirror = materials
    dev = _cuda("shade_bounce", cur_dir)
    r, nl, m = cur_dir.shape[0], light_pos.shape[0], phong.shape[0]
    ps = sph_dat.shape[1]
    shared = cur_org.dim() == 1
    f32, b8 = torch.float32, torch.bool
    for name, x, dtype, shape in (
            ("color", color, f32, (r, 3)),
            ("throughput", throughput, f32, (r, 3)),
            ("active", active, b8, (r,)),
            ("cur_org", cur_org, f32, (3,) if shared else (r, 3)),
            ("cur_dir", cur_dir, f32, (r, 3)),
            ("hit", hit, b8, (r,)),
            ("normal", normal, f32, (r, 3)),
            ("mat", mat, torch.int64, (r,)),
            ("point", point, f32, (r, 3)),
            ("offset", offset, f32, (r, 3)),
            ("mat_ambient", ambient, f32, (m, 3)),
            ("mat_diffuse", diffuse, f32, (m, 3)),
            ("mat_specular", specular, f32, (m, 3)),
            ("mat_mirror", mirror, f32, (m, 3)),
            ("mat_phong", phong, f32, (m,)),
            ("mat_is_mirror", is_mirror, b8, (m,)),
            ("light_pos", light_pos, f32, (nl, 3)),
            ("light_int", light_int, f32, (nl, 3)),
            ("ambient_light", ambient_light, f32, (3,)),
            ("background", background, f32, (3,)),
            ("sph_dat", sph_dat, f32, (4, ps))):
        _check(name, x, dtype, shape, dev)
    if nl:
        _check("occ", occ, torch.bool, (r, nl), dev)
    elif occ is not None:
        raise ValueError("occ is given for a scene without lights")
    if out is None:
        out = (torch.empty_like(color), torch.empty_like(throughput),
               torch.empty_like(active), torch.empty_like(cur_dir),
               torch.empty_like(cur_dir))
    for name, x, like in zip(("color", "throughput", "active", "cur_org",
                              "cur_dir"), out, (color, throughput, active,
                                                cur_dir, cur_dir)):
        _check("out " + name, x, like.dtype, like.shape, dev)
    # every lane's carry in its own buffer: an inactive lane keeps it as it is
    inplace = all(o.data_ptr() == c.data_ptr() for o, c in zip(out, carry))
    _launch("shade_bounce", "shade_bounce", dev, *carry, *record,
            occ if nl else 0, *materials, light_pos, light_int, ambient_light,
            background, sph_dat, *out, r, nl, ps, n_small, int(shared),
            int(first), int(inplace), int(relaxed), float(relevant_cos),
            float(rad_to_deg), float(gate_deg))
    return tuple(out)
