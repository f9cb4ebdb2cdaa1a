"""A kernel-level case of the hierarchical cluster mask, built with numpy
alone (``chip_smoke.py`` uses it too).

The hierarchical mask gates each 128-cluster chunk of a tile by a coarse
bit (the tile's rays against the union of the chunk's boxes) and writes 0
/ +inf on the chunks whose bit is 0.  A kernel that spreads a tile's live
chunks over blocks and warps must still write every (tile, column) once,
gate on the right bit and write only the C real columns of the last chunk.

C = 128 * 5 + 37 = 677 clusters (S = 6 chunks, the last one partial; 768
padded columns, above the 512 at which the port takes the hierarchical
route).  Chunk j lies along the x axis at x in [100 j, 100 j + 64]: cluster
m of the chunk is a box 0.4 wide in x at 100 j + 0.5 m, random in y and z
within [0, 10], the chunk's cluster 1 spans y and z in [0, 10] whole, and
every cluster k with k % 9 == 4 is empty (NaN).  The rays, 128 per tile:

=====  ==============================================  =====================
tile   rays                                            live chunks
=====  ==============================================  =====================
0      along +x through y, z in [2, 6]                 every one
1      along -y at x inside chunk 2                    2
2      along -z at x inside the last (partial) chunk   5
3      along +x at y = 50                              none
4      as tile 0, every ray inactive                   none (coarse bits
                                                       set in ``sup``)
5      along -y at x inside chunks 0 and 3, 30% of     0 and 3
       the rays inactive
6      along -x from x = -10 (the boxes behind)        none
7      as tile 0 with t windows ending at x = 250      0, 1 and 2
=====  ==============================================  =====================

A quarter of the rays of tiles 0, 4 and 7 keep y and z direction
components of exactly zero, the others a tilt below 0.002; the rays of
tiles 1, 2 and 5 have zero components on the two other axes.
"""

from __future__ import annotations

import numpy as np

TILE = 128
CLUSTER = 128
N_TILES = 8           # 1024 rays: the JAX calls' grid takes 8 tiles a step
N_CLUSTERS = 128 * 5 + 37
N_CHUNKS = -(-N_CLUSTERS // CLUSTER)

LIVE = {0: range(N_CHUNKS), 1: [2], 2: [N_CHUNKS - 1], 3: [], 4: [], 5: [0, 3],
        6: [], 7: [0, 1, 2]}


def _boxes(rng):
    k = np.arange(N_CLUSTERS)
    j, m = k // CLUSTER, k % CLUSTER
    lo = np.empty((N_CLUSTERS, 3), np.float32)
    hi = np.empty((N_CLUSTERS, 3), np.float32)
    lo[:, 0] = 100 * j + 0.5 * m
    hi[:, 0] = lo[:, 0] + 0.4
    lo[:, 1:] = rng.uniform(0, 8, (N_CLUSTERS, 2))
    hi[:, 1:] = lo[:, 1:] + rng.uniform(0.5, 2, (N_CLUSTERS, 2))
    lo[m == 1, 1:], hi[m == 1, 1:] = 0, 10
    lo[k % 9 == 4] = hi[k % 9 == 4] = np.nan
    return lo, hi


def _along_x(rng, sign=1.0):
    """128 rays along sign * x from x = -10 at y, z in [2, 6]; a quarter
    with zero y and z components, the rest tilted below 0.002."""
    o = np.stack([np.full(TILE, -10.0),
                  rng.uniform(2, 6, TILE), rng.uniform(2, 6, TILE)], 1)
    d = np.stack([np.full(TILE, sign), rng.uniform(-2e-3, 2e-3, TILE),
                  rng.uniform(-2e-3, 2e-3, TILE)], 1)
    d[::4, 1:] = 0.0
    return o, d


def _down(rng, x0, x1, axis):
    """128 rays along -axis (1: y, 2: z) from 20 above, at x in [x0, x1]
    and the third coordinate in [2, 6]."""
    o = np.empty((TILE, 3))
    o[:, 0] = rng.uniform(x0, x1, TILE)
    o[:, axis] = 20.0
    o[:, 3 - axis] = rng.uniform(2, 6, TILE)
    d = np.zeros((TILE, 3))
    d[:, axis] = -1.0
    return o, d


def hier_case(seed: int = 0) -> dict:
    """numpy inputs of one mask call: ``origin``, ``dirs`` (R, 3) f32,
    ``active`` (R,) bool, ``t_hi`` (R,) f32, ``cmin``, ``cmax`` (C, 3) f32;
    ``live`` (N_TILES, S) bool, the coarse bits the port's route must
    compute, and ``sup`` (N_TILES * S,) int32, the same with every bit of
    the inactive tile 4 set (the kernel must still write it 0 / +inf)."""
    rng = np.random.default_rng(seed)
    cmin, cmax = _boxes(rng)
    rays = [_along_x(rng), _down(rng, 201, 262, 1), _down(rng, 501, 517, 2),
            _along_x(rng), _along_x(rng), None, _along_x(rng, -1.0),
            _along_x(rng)]
    rays[3][0][:, 1] = 50.0
    a, b = _down(rng, 1, 62, 1), _down(rng, 301, 362, 1)
    rays[5] = tuple(np.concatenate([x[: TILE // 2], y[TILE // 2:]])
                    for x, y in zip(a, b))
    origin = np.concatenate([o for o, _ in rays]).astype(np.float32)
    dirs = np.concatenate([d for _, d in rays]).astype(np.float32)
    r = N_TILES * TILE
    active = np.ones(r, bool)
    active[4 * TILE:5 * TILE] = False
    active[5 * TILE:6 * TILE] = rng.random(TILE) > 0.3
    active[0:TILE:5] = False
    t_hi = np.full(r, 1e4, np.float32)
    t_hi[7 * TILE:] = 260.0
    live = np.zeros((N_TILES, N_CHUNKS), bool)
    for t, js in LIVE.items():
        live[t, list(js)] = True
    sup = live.copy()
    sup[4] = True
    return {"origin": origin, "dirs": dirs, "active": active, "t_hi": t_hi,
            "cmin": cmin, "cmax": cmax, "live": live,
            "sup": sup.astype(np.int32).reshape(-1)}
