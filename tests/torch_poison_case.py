"""A kernel-level case of the shadow kernels' NaN poison, built with numpy
alone (``chip_smoke.py`` uses it too).

The TPU shadow kernels keep a running max per (ray, lane) over a tile's
triangle visits that propagates NaN, and a lane occludes iff that max is
>= 0: a lane that is >= 0 in one visited cluster and NaN in another does
NOT occlude.  A kernel that splits a tile's visits over several warps must
merge the per-lane state before it folds lanes into the ray's bit.

Every plane value here is exact in float32: ray j of tile i starts at
(j, i, z) with integer j, i and dyadic z, and a lane's four planes are
+-(x - x0), +-(y - y0) with integer x0, y0 (zero z coefficients), so a
lane is >= 0 exactly for the rays of one band [x0, x1] of one tile.  XLA's
FMA contraction cannot move a result: the JAX kernels, the plain versions
and the CUDA kernels must agree bit for bit.

What the case holds, per light:

- each cluster has a few band lanes and a few NaN lanes at random; the
  other lanes are padding (-1, as ``build_shadow_planes`` pads);
- in each tile with at least 7 visits, a band of that tile at lane p of
  the cluster visited at position 1 and NaN at lane p of the cluster at
  position 6 (warp groups 1 and 2 of a 16-warp block), and another band at
  lane p' at position 1 with NaN at position 5 (the same warp group): the
  bands' rays are not occluded through those lanes;
- tiles whose list overflows (the bitmask scan), a full list, short lists
  and an empty tile.
"""

from __future__ import annotations

import numpy as np

TILE = 128
CLUSTER = 128
N_TILES = 8           # 1024 rays: the JAX calls' grid takes 8 tiles a step
N_CLUSTERS = 56
BANDS = 3             # random band lanes per cluster
POISONS = 2           # random NaN lanes per cluster

# candidate clusters per tile, per light: overflowing lists (the bitmask
# scan), a full list, short lists, an empty tile
COUNTS = ([N_CLUSTERS, 49, 48, 12, 7, 3, 0, 20],
          [30, 56, 9, 48, 0, 14, 7, 2])


def _band(x0, x1, y0):
    """(16,) rows of a lane that is >= 0 exactly on rays x0 <= x <= x1 of
    tile y0: min(x - x0, x1 - x, y - y0, y0 - y)."""
    return np.array([1, 0, 0, -x0, -1, 0, 0, x1,
                     0, 1, 0, -y0, 0, -1, 0, y0], np.float32)


_PAD = np.array([0, 0, 0, -1] + [0] * 12, np.float32)
_NAN = np.array([0, 0, 0, np.nan] + [0] * 12, np.float32)


def _visits(hit, entry, i):
    """Cluster ids of tile i in visit order: the front-to-back list (by
    entry; distinct here), or ascending when the count overflows 48."""
    ids = np.nonzero(hit[i])[0]
    if ids.size > 48:
        return ids
    return ids[np.argsort(entry[i, ids], kind="stable")]


def poison_case(n_lights: int, seed: int = 0) -> dict:
    """numpy inputs of one shadow call with ``n_lights`` lights: ``planes``
    (L, 16, Pt), ``thit`` a list of L (hit bool (nt, C), entry f32 (nt, C))
    pairs, ``shit`` one (hit, entry) pair of one never-hit sphere cluster,
    ``sph_dat`` (4, 128), ``origin`` (R, 3), ``lps`` (3 L,), and ``truth``
    (R,) int32, the bitfield the running-max rule gives."""
    rng = np.random.default_rng(seed)
    r = N_TILES * TILE
    j = np.tile(np.arange(TILE), N_TILES)
    i = np.repeat(np.arange(N_TILES), TILE)
    origin = np.stack([j, i, rng.integers(-16, 16, r) / 8.0], 1).astype(np.float32)
    planes = np.empty((n_lights, 16, N_CLUSTERS * CLUSTER), np.float32)
    thit = []
    for l in range(n_lights):
        lanes = np.repeat(_PAD[:, None], N_CLUSTERS * CLUSTER, 1)
        for k in range(N_CLUSTERS):
            pick = rng.choice(CLUSTER, BANDS + POISONS, replace=False)
            for p in pick[:BANDS]:
                x0 = int(rng.integers(0, TILE - 8))
                lanes[:, k * CLUSTER + p] = _band(x0, x0 + int(rng.integers(0, 8)),
                                                  int(rng.integers(0, N_TILES)))
            for p in pick[BANDS:]:
                lanes[:, k * CLUSTER + p] = _NAN
        hit = np.zeros((N_TILES, N_CLUSTERS), bool)
        for t, n in enumerate(COUNTS[l % 2]):
            hit[t, rng.choice(N_CLUSTERS, n, replace=False)] = True
        entry = np.stack([rng.permutation(N_CLUSTERS) for _ in range(N_TILES)]
                         ).astype(np.float32)
        for t in range(N_TILES):
            seq = _visits(hit, entry, t)
            if seq.size < 7:
                continue
            # lane p: a band at position 1, NaN at position 6 (another warp
            # group); lane p2: a band at 1, NaN at 5 (the same group)
            p = 32 * (t % 4) + 7 + t
            p2 = (p + 50) % CLUSTER
            x0 = 8 * t
            lanes[:, seq[1] * CLUSTER + p] = _band(x0, x0 + 5, t)
            lanes[:, seq[6] * CLUSTER + p] = _NAN
            lanes[:, seq[1] * CLUSTER + p2] = _band(x0 + 60, x0 + 63, t)
            lanes[:, seq[5] * CLUSTER + p2] = _NAN
        planes[l] = lanes
        thit.append((hit, entry))
    sph_dat = np.zeros((4, CLUSTER), np.float32)
    shit = (np.zeros((N_TILES, 1), bool), np.full((N_TILES, 1), np.inf, np.float32))
    lps = np.tile(np.array([64.0, 100.0, 0.0], np.float32), n_lights)
    return {"planes": planes, "thit": thit, "shit": shit, "sph_dat": sph_dat,
            "origin": origin, "lps": lps, "truth": _truth(planes, thit, origin)}


def _truth(planes, thit, origin):
    """The running-max rule in numpy (exact on this case)."""
    n_lights = planes.shape[0]
    found = np.zeros(N_TILES * TILE, np.int32)
    for l in range(n_lights):
        hit, entry = thit[l]
        for t in range(N_TILES):
            rays = slice(t * TILE, (t + 1) * TILE)
            o = origin[rays].astype(np.float32)
            acc = np.full((TILE, CLUSTER), -np.inf, np.float32)
            for k in _visits(hit, entry, t):
                rows = planes[l][:, k * CLUSTER:(k + 1) * CLUSTER]
                v = [o[:, 0:1] * rows[4 * a] + (o[:, 1:2] * rows[4 * a + 1]
                     + (o[:, 2:3] * rows[4 * a + 2] + rows[4 * a + 3]))
                     for a in range(4)]
                m = np.minimum(np.minimum(v[0], v[1]), np.minimum(v[2], v[3]))
                acc = np.maximum(acc, m)    # propagates NaN
            found[rays] |= (acc >= 0.0).any(1).astype(np.int32) << l
    return found


def poisoned_rays(case: dict) -> int:
    """Rays with a lane that is >= 0 in some visit but not occluded toward
    light 0: what a fold per visit group would get wrong."""
    planes, (hit, entry) = case["planes"][0], case["thit"][0]
    o = case["origin"]
    n = 0
    for t in range(N_TILES):
        rays = slice(t * TILE, (t + 1) * TILE)
        some = np.zeros(TILE, bool)
        for k in _visits(hit, entry, t):
            rows = planes[:, k * CLUSTER:(k + 1) * CLUSTER]
            v = [o[rays, 0:1] * rows[4 * a] + (o[rays, 1:2] * rows[4 * a + 1]
                 + (o[rays, 2:3] * rows[4 * a + 2] + rows[4 * a + 3]))
                 for a in range(4)]
            m = np.minimum(np.minimum(v[0], v[1]), np.minimum(v[2], v[3]))
            some |= (m >= 0.0).any(1)
        n += int((some & ((case["truth"][rays] & 1) == 0)).sum())
    return n
