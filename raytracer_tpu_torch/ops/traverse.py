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
  direction octant, nearer child first.  The walk's state lives in fixed
  buffers (``Walk``): a start, then blocks of ``_WALK_CHECK`` iterations,
  each ending with the loop test written into a flag that the host reads
  between blocks, so that a compiled program replays a block as one graph
  (``models.whitted._Wavefront``).

The engines return primitive ids (or occlusion bits) only and run under
``torch.no_grad()`` on detached inputs: visibility carries no gradient,
``ops.shade.refine_hit`` re-derives the hit from the ids.  Every shape is
fixed by the rays: the engines trace all R lanes, and the lanes that
``active`` leaves out return the fill (MISS or False), as the JAX
package's masked trace does (a walk's inactive lane starts finished).
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.models import programs
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

# the walk blocks run in this process and their iterations, counted by the
# host loop (``Walk.run``: a replayed block runs no Python)
walk_stats = {"blocks": 0, "iterations": 0}


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
                  bfc: bool = False, active=None):
    """(R,) int64 prim id of each ray's closest hit, MISS on a miss and on
    the lanes that ``active`` (when given) leaves out."""
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
    return best_p if active is None else torch.where(active, best_p, MISS)


@torch.no_grad()
def brute_any(data: SceneData, origin, dirs, t_max, chunk: int = 512,
              bfc: bool = False, active=None):
    """(R,) bool: some primitive has an accepted hit with t < t_max; False
    on the lanes that ``active`` (when given) leaves out."""
    dirs = dirs.detach()
    origin = origin.detach().expand(dirs.shape)
    t_max = t_max.detach()
    r = dirs.shape[0]
    found = torch.zeros((r,), dtype=torch.bool, device=dirs.device)
    for test, _ in _prim_chunks(data, chunk):
        for a, e in _ray_blocks(r):
            t, ok = test(origin[a:e], dirs[a:e], bfc)
            found[a:e] |= (ok & (t < t_max[a:e, None])).any(1)
    return found if active is None else found & active


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


class Walk:
    """The lockstep skip walk of ``bvh`` over ``n`` lanes as fixed state
    buffers: the rays (``origin``, ``dirs``, ``inv_d``, ``t_max``), per lane
    ``node``, ``end``, ``cursor``, ``remaining``, ``best_t``, ``best_p`` and
    ``done``, and ``flag``, the loop test (some lane not done with a node
    or a primitive left).  ``start`` loads rays and writes the first test;
    ``block`` runs ``_WALK_CHECK`` iterations and writes the test again;
    ``run`` runs blocks while the host reads the flag true: the schedule of
    a loop that tests its condition once every ``_WALK_CHECK`` iterations,
    so the same iterations as ever.  closest=True: closest hit with box
    t-pruning (``best_p``); False: any hit with t < t_max, each ray
    stopping at its first (``done``).  A lane that ``active`` leaves out
    starts finished (node = end, no primitive left): MISS and False."""

    def __init__(self, data: SceneData, bvh: DeviceBVH, n: int, closest: bool,
                 bfc: bool, device):
        self.data, self.bvh, self.closest, self.bfc = data, bvh, closest, bfc
        f32 = dict(dtype=torch.float32, device=device)
        i64 = dict(dtype=torch.int64, device=device)
        self.origin = torch.zeros((n, 3), **f32)
        self.dirs = torch.zeros((n, 3), **f32)
        self.inv_d = torch.zeros((n, 3), **f32)
        self.t_max = None if closest else torch.zeros((n,), **f32)
        self.node, self.end, self.cursor, self.remaining, self.best_p = (
            torch.zeros((n,), **i64) for _ in range(5))
        self.best_t = torch.zeros((n,), **f32)
        self.done = torch.zeros((n,), dtype=torch.bool, device=device)
        self.flag = torch.zeros((1,), dtype=torch.bool, device=device)

    @torch.no_grad()
    def start(self, origin, dirs, active=None, t_max=None) -> None:
        """Load the rays (``origin`` (3,) or (n, 3), ``dirs`` (n, 3),
        ``t_max`` (n,) for any-hit) and start every lane at its thread's
        root (its octant's with the octant threads)."""
        dirs = dirs.detach()
        self.dirs.copy_(dirs)
        self.origin.copy_(origin.detach().expand(dirs.shape))
        self.inv_d.copy_(1.0 / dirs)
        if not self.closest:
            self.t_max.copy_(t_max.detach())
        n = self.bvh.n_nodes
        if self.bvh.blocks == 8:
            neg = (dirs < 0.0).long()
            node = (neg[:, 0] * 4 + neg[:, 1] * 2 + neg[:, 2]) * n
        else:
            node = torch.zeros_like(self.node)
        self.end.copy_(node + n)
        self.node.copy_(node if active is None
                        else torch.where(active, node, self.end))
        self.cursor.zero_()
        self.remaining.zero_()
        self.best_t.fill_(float("inf"))
        self.best_p.fill_(MISS)
        self.done.zero_()
        self._test(self.node, self.remaining, self.done)

    def _test(self, node, remaining, done) -> None:
        self.flag.copy_((~done & ((node < self.end) | (remaining > 0)))
                        .any().reshape(1))

    @torch.no_grad()
    def block(self) -> None:
        """``_WALK_CHECK`` iterations, then the loop test into ``flag``."""
        data, bvh, closest = self.data, self.bvh, self.closest
        origin, dirs, inv_d, t_max, end = (self.origin, self.dirs, self.inv_d,
                                           self.t_max, self.end)
        n_total = bvh.blocks * bvh.n_nodes
        p_total = bvh.prim_idx.shape[0]
        node, cursor, remaining = self.node, self.cursor, self.remaining
        best_t, best_p, done = self.best_t, self.best_p, self.done
        for _ in range(_WALK_CHECK):
            in_leaf = (remaining > 0) & ~done
            # one primitive of the current leaf
            p = bvh.prim_idx[torch.clamp(cursor, 0, p_total - 1)]
            t_p, ok_p = _prim_test(data, origin, dirs, p, bfc=self.bfc)
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
        for buf, x in ((self.node, node), (self.cursor, cursor),
                       (self.remaining, remaining), (self.best_t, best_t),
                       (self.best_p, best_p), (self.done, done)):
            buf.copy_(x)
        self._test(node, remaining, done)

    def run(self, block=None) -> None:
        """Run blocks (``block``: the captured step of ``self.block``, or
        None to run it eagerly) while ``flag`` reads true."""
        n = programs.run_while(self.flag, block or self.block)
        walk_stats["blocks"] += n
        walk_stats["iterations"] += n * _WALK_CHECK


def _bvh_walk(data: SceneData, bvh: DeviceBVH, origin, dirs, t_max,
              closest: bool, bfc: bool = False, active=None):
    """An eager ``Walk`` of the rays: (best prim (R,), done (R,))."""
    walk = Walk(data, bvh, dirs.shape[0], closest, bfc, dirs.device)
    walk.start(origin, dirs, active, t_max)
    walk.run()
    return walk.best_p, walk.done


def bvh_closest(data: SceneData, bvh, origin, dirs, bfc: bool = False,
                active=None):
    return _bvh_walk(data, bvh, origin, dirs, None, closest=True, bfc=bfc,
                     active=active)[0]


def bvh_any(data: SceneData, bvh, origin, dirs, t_max, bfc: bool = False,
            active=None):
    return _bvh_walk(data, bvh, origin, dirs, t_max, closest=False, bfc=bfc,
                     active=active)[1]


def _device_bvh(accel) -> DeviceBVH:
    if not isinstance(accel, DeviceBVH):
        raise ValueError("the bvh engine walks a DeviceBVH "
                         "(models.bvh.device_bvh)")
    return accel


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
        return bvh_closest(data, _device_bvh(accel), origin, dirs, bfc=bfc,
                           active=active)
    if engine == "brute":
        return brute_closest(data, origin, dirs, bfc=bfc, active=active)
    raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")


def any_hit(data: SceneData, origin, dirs, t_max, accel, engine: str,
            active=None, bfc: bool = False, relaxed: bool = False,
            small_spheres: bool = True):
    """(R,) bool occlusion through ``engine``, False on the lanes that
    ``active`` (when given) leaves out; ``relaxed`` (sqrt- and
    division-free sphere sign tests) and ``small_spheres`` (False: without
    the dense test of a scene's few spheres, ``cluster_any``) apply to the
    cluster engine only."""
    if engine == "cluster":
        from raytracer_tpu_torch.ops.cluster_trace import cluster_any

        if accel is None:
            raise ValueError("the cluster engine needs a built ClusterSet")
        return cluster_any(accel, origin, dirs, t_max, active=active, bfc=bfc,
                           relaxed=relaxed, small_spheres=small_spheres)
    if engine == "bvh":
        return bvh_any(data, _device_bvh(accel), origin, dirs, t_max, bfc=bfc,
                       active=active)
    if engine == "brute":
        return brute_any(data, origin, dirs, t_max, bfc=bfc, active=active)
    raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")
