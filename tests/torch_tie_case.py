"""A kernel-level case of exact ties for the closest-hit and any-hit
kernels, built with numpy alone (``chip_smoke.py`` uses it too).

Every coordinate is a small dyadic number: the triangles are unit right
triangles on an integer grid (each unit quad split along its diagonal),
the rays start at multiples of 1/8 and step -1 in y per unit of t, and the
spheres have radius 1/2.  So every float32 operation of the Wald test is
exact, and the sphere roots differ only by one correctly rounded sqrt:
XLA's FMA contraction on the CPU cannot move a result, and the JAX
kernels, the plain versions and the CUDA kernels must agree bit for bit.

What the case holds:

- the same 200 triangles copied into 56 clusters, about 64 at random
  lanes of each: every hit ties exactly with its copies in other clusters
  (at the same lane: the earlier visit wins; at a lower lane: the lower
  lane wins, whatever its visit);
- triangles that share an edge (each quad's diagonal, and the quads'
  sides), which the rays often hit exactly, so that t ties across
  different triangles and clusters too;
- spheres whose tops touch a triangle layer: vertical rays through the
  centres tie a sphere with triangles (spheres visit after every
  triangle cluster);
- tiles whose candidate count overflows the 48-entry list (the bitmask
  scan), a full list, short lists, a sphere-only tile and an empty tile.
"""

from __future__ import annotations

import numpy as np

TILE = 128
CLUSTER = 128
N_TILES = 8           # 1024 rays: the JAX calls' grid takes 8 tiles a step
N_CLUSTERS = 56
PER_CLUSTER = 64


def _wald(a, b, c) -> np.ndarray:
    """(12,) float32 Wald rows of one triangle, as the cluster builders
    compute them (models/clusters.py): n, w1, w2, n.a, w1.a, w2.a."""
    a, b, c = (np.asarray(v, np.float64) for v in (a, b, c))
    e1, e2 = b - a, c - a
    n = np.cross(e1, e2)
    nn = float(n @ n) or 1.0
    w1 = np.cross(e2, n) / nn
    w2 = np.cross(n, e1) / nn
    return np.concatenate([n, w1, w2, [n @ a, w1 @ a, w2 @ a]]).astype(np.float32)


def _quad(x, y, z, up):
    """The two triangles of the unit quad at (x, z) in the plane y,
    sharing the diagonal (x+1, z) - (x, z+1); normal +y when ``up``."""
    p00, p10 = (x, y, z), (x + 1, y, z)
    p01, p11 = (x, y, z + 1), (x + 1, y, z + 1)
    tris = [(p00, p10, p01), (p10, p11, p01)]
    return [(a, c, b) if up else (a, b, c) for a, b, c in tris]


def _triangles():
    tris = []
    for x in range(8):
        for z in range(8):
            if (x + z) % 2 == 0:      # a checkerboard: rays fall through
                tris += _quad(x, 0, z, up=x < 4)
            tris += _quad(x, -1, z, up=True)
    for x in (12, 13):                # the sphere tops' layer
        for z in (0, 1):
            tris += _quad(x, 1.5, z, up=True)
    return np.stack([_wald(*t) for t in tris], axis=1)   # (12, 200)


SPHERES = [(12.5, 1.0, 0.5), (13.5, 1.0, 0.5), (12.5, 1.0, 1.5), (13.5, 1.0, 1.5)]


def tie_case(seed: int = 0) -> dict:
    """numpy inputs of one closest / any-hit call: ``tri_dat`` (12, Pt),
    ``sph_dat`` (4, 128), dense candidate masks ``thit`` / ``shit`` as
    (hit bool (nt, C), entry f32 (nt, C)) pairs, per-ray ``origin`` and
    ``dirs`` (R, 3), the shared-origin form ``eye`` (3,) and ``eye_dirs``,
    and ``t_max`` (R,)."""
    rng = np.random.default_rng(seed)
    rows = _triangles()
    n_tri = rows.shape[1]
    tri_dat = np.zeros((12, N_CLUSTERS * CLUSTER), np.float32)
    for k in range(N_CLUSTERS):
        lanes = rng.choice(CLUSTER, PER_CLUSTER, replace=False)
        tri_dat[:, k * CLUSTER + lanes] = rows[:, rng.choice(n_tri, PER_CLUSTER,
                                                             replace=False)]
    sph_dat = np.zeros((4, CLUSTER), np.float32)
    for lane, c in zip((3, 40, 90, 127), SPHERES):
        sph_dat[:, lane] = (*c, 0.5)

    # candidate clusters per tile: all 56 and 49 (the bitmask scan), a full
    # list, short lists, a sphere-only tile (5) and an empty tile (6)
    counts = [N_CLUSTERS, 49, 48, 10, 1, 0, 0, 20]
    hit = np.zeros((N_TILES, N_CLUSTERS), bool)
    for i, n in enumerate(counts):
        hit[i, rng.choice(N_CLUSTERS, n, replace=False)] = True
    entry = rng.integers(0, 8, hit.shape).astype(np.float32)  # many ties
    shit = np.array([[1], [0], [1], [1], [0], [1], [0], [1]], bool)
    sentry = np.zeros(shit.shape, np.float32)

    r = N_TILES * TILE
    eighths = lambda lo, hi, n: rng.integers(lo * 8, hi * 8 + 1, n) / 8.0  # noqa: E731
    origin = np.stack([eighths(0, 8, r), np.full(r, 4.0), eighths(0, 8, r)], 1)
    dirs = np.stack([eighths(-0.5, 0.5, r), -np.ones(r), eighths(-0.5, 0.5, r)], 1)
    # tile 7: vertical rays over the spheres, a third through their centres
    v = slice(7 * TILE, 8 * TILE)
    cen = np.array(SPHERES)[rng.integers(0, len(SPHERES), TILE)]
    off = np.where(rng.random((TILE, 1)) < 1 / 3, 0.0,
                   rng.integers(-3, 4, (TILE, 2)) / 8.0)
    origin[v, 0] = cen[:, 0] + off[:, 0]
    origin[v, 2] = cen[:, 2] + off[:, 1]
    dirs[v, 0] = dirs[v, 2] = 0.0
    # the shared eye (4, 4, 4) toward points of the y = 0 grid at 1/8 steps
    eye = np.array([4.0, 4.0, 4.0])
    eye_dirs = np.stack([(eighths(0, 8, r) - 4.0) / 4.0, -np.ones(r),
                         (eighths(0, 8, r) - 4.0) / 4.0], 1)
    # t_max: unbounded, exactly a layer's t (strict: not found), between
    # the layers, at the sphere tops, and short of everything
    t_max = rng.choice(np.array([1e9, 4.0, 4.5, 5.0, 2.5, 1.0]), r)
    f32 = lambda x: np.ascontiguousarray(x, np.float32)  # noqa: E731
    return {"tri_dat": tri_dat, "sph_dat": sph_dat,
            "thit": (hit, entry), "shit": (shit, sentry),
            "origin": f32(origin), "dirs": f32(dirs), "eye": f32(eye),
            "eye_dirs": f32(eye_dirs), "t_max": f32(t_max)}
