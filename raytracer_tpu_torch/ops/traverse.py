"""The brute and BVH visibility engines and the engine dispatch (port of
``raytracer_tpu/ops/traverse.py``).

- ``brute``: every ray against every primitive, in primitive chunks of
  ``chunk`` with a running (t, prim) minimum.  Chunk starts follow the
  JAX package (``_chunk_starts``: the last start is clamped, so the last
  two chunks may overlap; min and any are idempotent).  The strict ``<``
  across chunks and the first-index argmin inside one keep the lowest id
  on an exact t tie, so a triangle beats a sphere, as in the reference's
  leaf order.  Rays go in blocks of ``_RAY_BLOCK`` so the (rays, chunk)
  temporaries stay bounded.
- ``bvh``: the lockstep walk of the flat skip-threaded BVH
  (``models.bvh.DeviceBVH``, from ``device_bvh``): per ray one
  node cursor and one leaf cursor, no stack.  Each iteration a ray either
  tests one primitive of its current leaf or one node box (hit: node+1,
  miss: skip[node]).  Closest-hit prunes boxes entered beyond its best t;
  any-hit never prunes and stops each ray at its first hit.  With the
  octant threads (``blocks`` 8) each ray walks the preorder of its
  direction octant, nearer child first.

The engines return primitive ids (or occlusion bits) only and run under
``torch.no_grad()`` on detached inputs: visibility carries no gradient,
``ops.shade.refine_hit`` re-derives the hit from the ids.  The dispatch
(``closest_hit``, ``any_hit``) runs brute and bvh on the ``active`` lanes
only: the integrator reads no other lane (the JAX package traces them all
and masks the results).
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.models.bvh import DeviceBVH
from raytracer_tpu_torch.models.scene import SceneData
from raytracer_tpu_torch.ops.intersect import (
    aabb_intersect, sphere_intersect, tri_intersect,
)

# prim ids: [0, T_pad) triangles, [T_pad, T_pad + S_pad) spheres
MISS = -1
ENGINES = ("brute", "bvh", "cluster")

_RAY_BLOCK = 1 << 14

# the lockstep walk tests its loop condition (a host sync) once every
# _WALK_CHECK iterations: an iteration changes nothing for a ray that is
# done, or past its end with no primitive left, so extra ones are no-ops
_WALK_CHECK = 8


def _gather_tris(data: SceneData):
    v = data.tri_v.long()
    return (data.vertices[v[:, 0]], data.vertices[v[:, 1]],
            data.vertices[v[:, 2]])


def _chunk_starts(total: int, chunk: int):
    """(starts, size) of fixed-size chunks covering [0, total), the last
    start clamped to total - size; (None, 0) for no primitives."""
    if total <= 0:
        return None, 0
    chunk = min(chunk, total)
    n = (total + chunk - 1) // chunk
    return [min(i * chunk, total - chunk) for i in range(n)], chunk


def _prim_chunks(data: SceneData, chunk: int):
    """Per primitive chunk: (test(origin, dirs, bfc) -> (t, ok) of shape
    (R, size), ids (size,)), triangles then spheres."""
    t_pad = data.tri_v.shape[0]
    a, b, c = _gather_tris(data)
    out = []
    starts, size = _chunk_starts(t_pad, chunk)
    for s in starts or ():
        ca, cb, cc = a[s:s + size], b[s:s + size], c[s:s + size]
        valid = data.tri_valid[s:s + size]

        def tri(o, d, bfc, ca=ca, cb=cb, cc=cc, valid=valid):
            t, ok = tri_intersect(o[:, None], d[:, None], ca[None], cb[None],
                                  cc[None], bfc=bfc)
            return t, ok & valid[None]
        out.append((tri, torch.arange(s, s + size, device=a.device)))
    center = data.vertices[data.sphere_cvid.long()]
    starts, size = _chunk_starts(data.sphere_cvid.shape[0], chunk)
    for s in starts or ():
        cen, rad = center[s:s + size], data.sphere_rad[s:s + size]
        valid = data.sphere_valid[s:s + size]

        def sph(o, d, bfc, cen=cen, rad=rad, valid=valid):
            t, ok = sphere_intersect(o[:, None], d[:, None], cen[None],
                                     rad[None])
            return t, ok & valid[None]
        out.append((sph, torch.arange(t_pad + s, t_pad + s + size,
                                      device=a.device)))
    return out


def _ray_blocks(r: int):
    for s in range(0, r, _RAY_BLOCK):
        yield s, min(s + _RAY_BLOCK, r)


@torch.no_grad()
def brute_closest(data: SceneData, origin, dirs, chunk: int = 512,
                  bfc: bool = False):
    """(R,) int64 prim id of each ray's closest hit, MISS on a miss."""
    dirs = dirs.detach()
    origin = origin.detach().expand(dirs.shape)
    r = dirs.shape[0]
    best_t = torch.full((r,), float("inf"), device=dirs.device)
    best_p = torch.full((r,), MISS, dtype=torch.int64, device=dirs.device)
    for test, ids in _prim_chunks(data, chunk):
        for a, e in _ray_blocks(r):
            t, ok = test(origin[a:e], dirs[a:e], bfc)
            t = torch.where(ok, t, float("inf"))
            tj, j = t.min(dim=1)
            upd = tj < best_t[a:e]
            best_t[a:e] = torch.where(upd, tj, best_t[a:e])
            best_p[a:e] = torch.where(upd, ids[j], best_p[a:e])
    return best_p


@torch.no_grad()
def brute_any(data: SceneData, origin, dirs, t_max, chunk: int = 512,
              bfc: bool = False):
    """(R,) bool: some primitive has an accepted hit with t < t_max."""
    dirs = dirs.detach()
    origin = origin.detach().expand(dirs.shape)
    t_max = t_max.detach()
    r = dirs.shape[0]
    found = torch.zeros((r,), dtype=torch.bool, device=dirs.device)
    for test, _ in _prim_chunks(data, chunk):
        for a, e in _ray_blocks(r):
            t, ok = test(origin[a:e], dirs[a:e], bfc)
            found[a:e] |= (ok & (t < t_max[a:e, None])).any(1)
    return found


def _prim_test(data: SceneData, origin, dirs, p, bfc: bool = False):
    """(t, ok) of each ray against its own primitive id ``p`` (R,)."""
    t_pad = data.tri_v.shape[0]
    s_pad = data.sphere_cvid.shape[0]
    is_tri = p < t_pad
    v = data.tri_v[torch.clamp(p, 0, t_pad - 1)].long()
    t_tri, ok_tri = tri_intersect(origin, dirs, data.vertices[v[:, 0]],
                                  data.vertices[v[:, 1]],
                                  data.vertices[v[:, 2]], bfc=bfc)
    si = torch.clamp(p - t_pad, 0, s_pad - 1)
    center = data.vertices[data.sphere_cvid[si].long()]
    t_sph, ok_sph = sphere_intersect(origin, dirs, center,
                                     data.sphere_rad[si])
    return (torch.where(is_tri, t_tri, t_sph),
            torch.where(is_tri, ok_tri, ok_sph))


@torch.no_grad()
def _bvh_walk(data: SceneData, bvh: DeviceBVH, origin, dirs, t_max, closest: bool,
              bfc: bool = False):
    """The lockstep skip walk: (best prim (R,), done (R,)).  closest=True:
    closest hit with box t-pruning; False: any hit with t < t_max, each
    ray stopping at its first."""
    dirs = dirs.detach()
    origin = origin.detach().expand(dirs.shape)
    dev = dirs.device
    r = dirs.shape[0]
    n = bvh.n_nodes
    n_total = bvh.blocks * n
    p_total = bvh.prim_idx.shape[0]
    inv_d = 1.0 / dirs
    if bvh.blocks == 8:
        octant = ((dirs < 0.0).long()
                  * torch.tensor([4, 2, 1], device=dev)).sum(-1)
        node = octant * n
    else:
        node = torch.zeros((r,), dtype=torch.int64, device=dev)
    end = node + n
    cursor = torch.zeros((r,), dtype=torch.int64, device=dev)
    remaining = torch.zeros((r,), dtype=torch.int64, device=dev)
    best_t = torch.full((r,), float("inf"), device=dev)
    best_p = torch.full((r,), MISS, dtype=torch.int64, device=dev)
    done = torch.zeros((r,), dtype=torch.bool, device=dev)
    it = 0
    while it % _WALK_CHECK or bool((~done & ((node < end)
                                             | (remaining > 0))).any()):
        it += 1
        in_leaf = (remaining > 0) & ~done
        # one primitive of the current leaf
        p = bvh.prim_idx[torch.clamp(cursor, 0, p_total - 1)]
        t_p, ok_p = _prim_test(data, origin, dirs, p, bfc=bfc)
        if closest:
            upd = in_leaf & ok_p & (t_p < best_t)
            best_t = torch.where(upd, t_p, best_t)
            best_p = torch.where(upd, p, best_p)
        else:
            found = in_leaf & ok_p & (t_p < t_max)
            best_p = torch.where(found & (best_p == MISS), p, best_p)
            done = done | found
        cursor = torch.where(in_leaf, cursor + 1, cursor)
        remaining = torch.where(in_leaf, remaining - 1, remaining)
        # one node box
        at_node = ~in_leaf & (node < end) & ~done
        ni = torch.clamp(node, 0, n_total - 1)
        tmin, ok_box = aabb_intersect(origin, inv_d, bvh.box_min[ni],
                                      bvh.box_max[ni])
        visit = ok_box & (tmin <= best_t) if closest else ok_box
        count = bvh.leaf_count[ni]
        enter_leaf = at_node & visit & (count > 0)
        node = torch.where(at_node, torch.where(visit, node + 1,
                                                bvh.skip[ni]), node)
        remaining = torch.where(enter_leaf, count, remaining)
        cursor = torch.where(enter_leaf, bvh.leaf_start[ni], cursor)
    return best_p, done


def bvh_closest(data: SceneData, bvh, origin, dirs, bfc: bool = False):
    return _bvh_walk(data, bvh, origin, dirs, None, closest=True, bfc=bfc)[0]


def bvh_any(data: SceneData, bvh, origin, dirs, t_max, bfc: bool = False):
    return _bvh_walk(data, bvh, origin, dirs, t_max.detach(), closest=False,
                     bfc=bfc)[1]


def _active_lanes(fn, active, fill, origin, dirs, *per_ray):
    """fn(origin, dirs, *per_ray) on the ``active`` lanes only, ``fill`` on
    the others (whose results the integrator never reads)."""
    if active is None:
        return fn(origin, dirs, *per_ray)
    origin = origin.expand(dirs.shape)
    idx = torch.nonzero(active).squeeze(1)
    got = fn(origin[idx], dirs[idx], *(x[idx] for x in per_ray))
    out = torch.full(active.shape, fill, dtype=got.dtype, device=got.device)
    out[idx] = got
    return out


def closest_hit(data: SceneData, origin, dirs, accel, engine: str,
                active=None, bfc: bool = False):
    """(R,) prim ids of the closest hits through ``engine`` (brute, bvh
    with a DeviceBVH, cluster with a ClusterSet); MISS on the lanes that
    ``active`` (when given) leaves out."""
    if engine == "cluster":
        from raytracer_tpu_torch.ops.cluster_trace import cluster_closest

        if accel is None:
            raise ValueError("the cluster engine needs a built ClusterSet")
        return cluster_closest(accel, origin, dirs, active=active, bfc=bfc)
    if engine == "bvh":
        if not isinstance(accel, DeviceBVH):
            raise ValueError("the bvh engine walks a DeviceBVH "
                             "(models.bvh.device_bvh)")
        fn = lambda o, d: bvh_closest(data, accel, o, d, bfc=bfc)  # noqa: E731
    elif engine == "brute":
        fn = lambda o, d: brute_closest(data, o, d, bfc=bfc)  # noqa: E731
    else:
        raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")
    return _active_lanes(fn, active, MISS, origin, dirs)


def any_hit(data: SceneData, origin, dirs, t_max, accel, engine: str,
            active=None, bfc: bool = False, relaxed: bool = False):
    """(R,) bool occlusion through ``engine``, False on the lanes that
    ``active`` (when given) leaves out; ``relaxed`` (sqrt- and
    division-free sphere sign tests) applies to the cluster engine only."""
    if engine == "cluster":
        from raytracer_tpu_torch.ops.cluster_trace import cluster_any

        if accel is None:
            raise ValueError("the cluster engine needs a built ClusterSet")
        return cluster_any(accel, origin, dirs, t_max, active=active, bfc=bfc,
                           relaxed=relaxed)
    if engine == "bvh":
        if not isinstance(accel, DeviceBVH):
            raise ValueError("the bvh engine walks a DeviceBVH "
                             "(models.bvh.device_bvh)")
        fn = lambda o, d, t: bvh_any(data, accel, o, d, t, bfc=bfc)  # noqa: E731
    elif engine == "brute":
        fn = lambda o, d, t: brute_any(data, o, d, t, bfc=bfc)  # noqa: E731
    else:
        raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")
    return _active_lanes(fn, active, False, origin, dirs, t_max)
