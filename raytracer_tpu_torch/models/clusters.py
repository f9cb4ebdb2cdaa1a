"""Cluster acceleration structure (port of ``raytracer_tpu/models/clusters.py``).

Primitives are reordered into spatially coherent clusters of CLUSTER = 128
slots, in the BVH's preorder leaf sequence; every ray tile is slab-tested
against every cluster box (``ops.cluster_trace``) and the surviving
(tile, cluster) pairs are intersected densely by the kernels in
``ops.kernels``.  Triangles are stored in the Wald projection form
(n = e1 x e2 and the dual edge basis w1, w2 with their products with
vertex a); spheres as (center, radius).  The default layout runs 128
triangles a cluster in BVH preorder; ``treelet=True`` starts a cluster at
every BVH subtree of at most 128 primitives, which leaves padded gaps
among the triangle slots.  A padding slot is all zeros in ``tri_dat``
(t = 0/0 = NaN: no test passes) and ``tri_verts`` (its shadow planes
never occlude), so no consumer needs the valid slots to be a prefix.

The build is host numpy (float64 where the JAX package uses it), so
every array equals the JAX package's bit for bit; the result is moved
to the scene's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from raytracer_tpu_torch.models.bvh import BVH
from raytracer_tpu_torch.models.scene import SceneData, SceneMeta, tensors_to

CLUSTER = 128  # primitives per cluster (one kernel tile of lanes)


@dataclasses.dataclass(frozen=True)
class ClusterSet:
    """Pt/Ps are the padded (multiple-of-CLUSTER) triangle/sphere slot
    counts, Ct/Cs the cluster counts.  ``*_slot`` maps a slot to the
    global primitive id (tris [0, T), spheres T + s)."""

    tri_dat: torch.Tensor    # (12, Pt) f32: n, w1, w2 (xyz each), n.a, w1.a, w2.a
    tri_slot: torch.Tensor   # (Pt,) i32
    tri_cmin: torch.Tensor   # (Ct, 3) f32 cluster box; NaN for empty clusters
    tri_cmax: torch.Tensor   # (Ct, 3) f32
    sph_dat: torch.Tensor    # (4, Ps) f32: cx, cy, cz, r
    sph_slot: torch.Tensor   # (Ps,) i32
    sph_cmin: torch.Tensor   # (Cs, 3) f32
    sph_cmax: torch.Tensor   # (Cs, 3) f32
    # per-slot shading table, tris then spheres (Pt + Ps rows): 0-2 tri
    # unit normal or sphere center, 3 sphere radius, 4 material id, 5
    # global prim id (exact small ints in f32), 6-7 padding
    slot_pack: torch.Tensor  # (Pt+Ps, 8) f32
    # verbatim triangle vertices per slot (a, b, c rows; zero on padding):
    # the source of the per-light shadow plane tables
    tri_verts: torch.Tensor  # (9, Pt) f32
    n_tri: int = 0
    n_sph: int = 0

    def to(self, device) -> "ClusterSet":
        return tensors_to(self, device)


def _pad_to_multiple(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


def _treelet_slots(bvh: BVH, max_size: int) -> np.ndarray:
    """Slot of each BVH preorder primitive position in the treelet layout:
    top down, the largest subtrees of at most ``max_size`` primitives (and
    leaves, cut into ``max_size`` runs) each start a new cluster, whose
    preorder primitive range is contiguous; a cluster's unused slots stay
    padding."""
    counts = np.asarray(bvh.leaf_count, np.int64)
    skip = np.asarray(bvh.skip, np.int64)
    n = counts.shape[0]
    cum = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=cum[1:])  # cum[i] = prims before node i (preorder)
    ranges = []  # (lo, hi) prim ranges, preorder-ascending
    stack = [0]
    while stack:
        i = stack.pop()
        lo, hi = cum[i], cum[skip[i]]
        if hi <= lo:
            continue
        if hi - lo <= max_size or counts[i] > 0:
            for s in range(lo, hi, max_size):
                ranges.append((s, min(s + max_size, hi)))
        else:  # inner node: left i + 1, right skip[i + 1], preorder kept
            stack.append(skip[i + 1])
            stack.append(i + 1)
    slot = np.zeros(cum[n], np.int64)
    base = 0
    for lo, hi in ranges:
        slot[lo:hi] = base + np.arange(hi - lo)
        base += CLUSTER * (-(-(hi - lo) // CLUSTER))
    return slot


def cluster_arrays(data: SceneData, meta: SceneMeta,
                   bvh: Optional[BVH] = None, treelet: bool = False) -> dict:
    """The ClusterSet fields as numpy arrays (plus ``n_tri``/``n_sph``)."""
    verts = data.vertices.cpu().numpy().astype(np.float32)
    tri_v = data.tri_v.cpu().numpy().astype(np.int64)
    t_pad = tri_v.shape[0]
    n_tri, n_sph = meta.n_tris, meta.n_spheres

    tri_pos = np.arange(n_tri, dtype=np.int64)  # slot of each triangle
    if bvh is not None:
        order = np.asarray(bvh.prim_idx, np.int64)
        tri_order = order[order < t_pad][:n_tri]
        sph_order = order[order >= t_pad][:n_sph] - t_pad
        if tri_order.shape[0] != n_tri:
            tri_order = np.arange(n_tri, dtype=np.int64)
        if sph_order.shape[0] != n_sph:
            sph_order = np.arange(n_sph, dtype=np.int64)
        if treelet and n_tri:
            # the partition of the whole primitive sequence, projected on
            # the triangles: spheres leave gaps (they keep their own runs)
            slot_all = _treelet_slots(bvh, CLUSTER)
            tri_pos = slot_all[np.nonzero(order < t_pad)[0][:n_tri]]
            # clusters left without a triangle are dropped
            used = np.zeros((int(tri_pos.max()) // CLUSTER + 1,), bool)
            used[tri_pos // CLUSTER] = True
            remap = np.cumsum(used) - 1
            tri_pos = remap[tri_pos // CLUSTER] * CLUSTER + tri_pos % CLUSTER
    else:
        tri_order = np.arange(n_tri, dtype=np.int64)
        sph_order = np.arange(n_sph, dtype=np.int64)

    # --- triangles in Wald projection form
    Pt = _pad_to_multiple(int(tri_pos.max()) + 1 if n_tri else 0, CLUSTER)
    tri_dat = np.zeros((12, Pt), np.float32)
    tri_slot = np.zeros((Pt,), np.int32)
    if n_tri:
        v = tri_v[tri_order]
        a = verts[v[:, 0]].astype(np.float64)
        b = verts[v[:, 1]].astype(np.float64)
        c = verts[v[:, 2]].astype(np.float64)
        e1 = b - a
        e2 = c - a
        n = np.cross(e1, e2)
        nn = (n * n).sum(-1, keepdims=True)
        nn = np.where(nn == 0.0, 1.0, nn)  # degenerate tris can never hit
        w1 = np.cross(e2, n) / nn
        w2 = np.cross(n, e1) / nn
        tri_dat[0:3, tri_pos] = n.T
        tri_dat[3:6, tri_pos] = w1.T
        tri_dat[6:9, tri_pos] = w2.T
        tri_dat[9, tri_pos] = (n * a).sum(-1)
        tri_dat[10, tri_pos] = (w1 * a).sum(-1)
        tri_dat[11, tri_pos] = (w2 * a).sum(-1)
        tri_slot[tri_pos] = tri_order.astype(np.int32)

    Ct = Pt // CLUSTER
    tri_cmin = np.full((Ct, 3), np.inf, np.float32)
    tri_cmax = np.full((Ct, 3), -np.inf, np.float32)
    if n_tri:
        corners = verts[tri_v[tri_order]]  # (n_tri, 3, 3)
        ci_of = tri_pos // CLUSTER
        np.minimum.at(tri_cmin, ci_of, corners.min(axis=1))
        np.maximum.at(tri_cmax, ci_of, corners.max(axis=1))

    # --- spheres
    Ps = _pad_to_multiple(n_sph, CLUSTER)
    sph_dat = np.zeros((4, Ps), np.float32)
    sph_slot = np.zeros((Ps,), np.int32)
    Cs = Ps // CLUSTER
    sph_cmin = np.full((Cs, 3), np.inf, np.float32)
    sph_cmax = np.full((Cs, 3), -np.inf, np.float32)
    if n_sph:
        centers = verts[data.sphere_cvid.cpu().numpy().astype(np.int64)[sph_order]]
        radii = data.sphere_rad.cpu().numpy().astype(np.float32)[sph_order]
        sph_dat[0:3, :n_sph] = centers.T
        sph_dat[3, :n_sph] = radii
        sph_slot[:n_sph] = (t_pad + sph_order).astype(np.int32)
        for ci in range(Cs):
            s, e = ci * CLUSTER, min((ci + 1) * CLUSTER, n_sph)
            if s < e:
                sph_cmin[ci] = (centers[s:e] - radii[s:e, None]).min(axis=0)
                sph_cmax[ci] = (centers[s:e] + radii[s:e, None]).max(axis=0)

    # clusters with NO primitives get NaN boxes: every slab comparison is
    # then False in both mask forms, so they are never listed or visited
    # (inf/-inf boxes would HIT every ray in the min/max slab test)
    empty_t = ~(tri_cmax >= tri_cmin).all(axis=1)
    tri_cmin[empty_t] = np.nan
    tri_cmax[empty_t] = np.nan
    empty_s = ~(sph_cmax >= sph_cmin).all(axis=1)
    sph_cmin[empty_s] = np.nan
    sph_cmax[empty_s] = np.nan

    slot_pack = np.zeros((Pt + Ps, 8), np.float32)
    tri_verts = np.zeros((9, Pt), np.float32)
    tri_mat = data.tri_mat.cpu().numpy().astype(np.int32)
    if n_tri:
        v = tri_v[tri_order]
        a32 = verts[v[:, 0]]
        b32 = verts[v[:, 1]]
        c32 = verts[v[:, 2]]
        n32 = np.cross(b32 - a32, c32 - a32).astype(np.float32)
        norm = np.linalg.norm(n32, axis=-1, keepdims=True)
        slot_pack[tri_pos, 0:3] = n32 / norm
        slot_pack[tri_pos, 4] = tri_mat[tri_order]
        slot_pack[tri_pos, 5] = tri_order
        tri_verts[0:3, tri_pos] = a32.T
        tri_verts[3:6, tri_pos] = b32.T
        tri_verts[6:9, tri_pos] = c32.T
    if n_sph:
        slot_pack[Pt : Pt + n_sph, 0:3] = centers
        slot_pack[Pt : Pt + n_sph, 3] = radii
        slot_pack[Pt : Pt + n_sph, 4] = data.sphere_mat.cpu().numpy().astype(
            np.int32)[sph_order]
        slot_pack[Pt : Pt + n_sph, 5] = t_pad + sph_order

    return dict(
        tri_dat=tri_dat, tri_slot=tri_slot,
        tri_cmin=tri_cmin, tri_cmax=tri_cmax,
        sph_dat=sph_dat, sph_slot=sph_slot,
        sph_cmin=sph_cmin, sph_cmax=sph_cmax,
        slot_pack=slot_pack, tri_verts=tri_verts,
        n_tri=n_tri, n_sph=n_sph,
    )


def build_clusters(data: SceneData, meta: SceneMeta,
                   bvh: Optional[BVH] = None, treelet: bool = False) -> ClusterSet:
    """Host-side build; the ClusterSet lands on the scene's device.  With
    a BVH its preorder primitive sequence gives the spatial clustering,
    without one file order is used.  ``treelet`` (with a BVH) aligns the
    triangle clusters to BVH subtrees: tighter boxes, more clusters."""
    from raytracer_tpu_torch.convert import clusters_from_numpy

    return clusters_from_numpy(cluster_arrays(data, meta, bvh, treelet),
                               data.device)
