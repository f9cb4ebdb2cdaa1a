"""BVH: host-side build -> flat, skip-threaded struct-of-arrays.

Port of ``raytracer_tpu/models/bvh.py`` without the octant threads (the
BVH engine that reads them is not ported yet).  The reference's recipe:
top-down, split on the WIDEST axis at the spatial MIDPOINT with up to 19
bisection retries toward the non-empty side; a node becomes a leaf at
<= 1 primitive, depth 19 or a failed split.  Nodes are in PREORDER and
carry a SKIP index (the next preorder node outside the subtree).  Leaves
reference a contiguous range of the reordered ``prim_idx`` (triangles
before spheres within a leaf).

The arrays stay numpy: the only consumer here is the host-side cluster
build, which needs ``prim_idx`` (the preorder primitive sequence).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from raytracer_tpu_torch.models.scene import SceneData, SceneMeta

MAX_BVH_DEPTH = 19
SPLIT_RETRIES = 19


@dataclasses.dataclass(frozen=True)
class BVH:
    """Flat skip-threaded BVH (host numpy arrays).  Primitive ids encode
    triangles as [0, T_pad) and spheres as T_pad + s."""

    box_min: np.ndarray      # (N, 3) f32
    box_max: np.ndarray      # (N, 3) f32
    skip: np.ndarray         # (N,)  i32, next preorder node outside this subtree
    leaf_start: np.ndarray   # (N,)  i32, into prim_idx; 0 for inner nodes
    leaf_count: np.ndarray   # (N,)  i32, 0 for inner nodes
    axis: np.ndarray         # (N,)  i32, split axis (inner nodes)
    prim_idx: np.ndarray     # (P,)  i32, reordered primitive ids


def _build_native(prim_min, prim_max, centers, prim_ids):
    """Build through the tracked C++ library; None if it does not load.
    Bit-identical to the numpy path (both are float32 midpoint bisection)."""
    import ctypes

    from raytracer_tpu_torch.utils.native import load

    lib = load()
    if lib is None:
        return None
    n = prim_ids.shape[0]
    cap = 2 * n + 1
    f32, i32 = np.float32, np.int32
    pmin = np.ascontiguousarray(prim_min, f32)
    pmax = np.ascontiguousarray(prim_max, f32)
    cen = np.ascontiguousarray(centers, f32)
    pid = np.ascontiguousarray(prim_ids, i32)
    node_min = np.empty((cap, 3), f32)
    node_max = np.empty((cap, 3), f32)
    skip = np.empty((cap,), i32)
    leaf_start = np.empty((cap,), i32)
    leaf_count = np.empty((cap,), i32)
    axis = np.empty((cap,), i32)
    prim_out = np.empty((n,), i32)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    cf, ci = ctypes.c_float, ctypes.c_int32
    n_nodes = lib.rt_build_bvh(
        n, p(pmin, cf), p(pmax, cf), p(cen, cf), p(pid, ci),
        MAX_BVH_DEPTH, SPLIT_RETRIES,
        p(node_min, cf), p(node_max, cf), p(skip, ci), p(leaf_start, ci),
        p(leaf_count, ci), p(axis, ci), p(prim_out, ci), cap,
    )
    if n_nodes <= 0:
        return None
    return BVH(
        box_min=node_min[:n_nodes].copy(),
        box_max=node_max[:n_nodes].copy(),
        skip=skip[:n_nodes].copy(),
        leaf_start=leaf_start[:n_nodes].copy(),
        leaf_count=leaf_count[:n_nodes].copy(),
        axis=axis[:n_nodes].copy(),
        prim_idx=prim_out,
    )


def build_bvh(data: SceneData, meta: SceneMeta) -> BVH:
    """Build on the host from the scene's tensors (read back to numpy)."""
    verts = data.vertices.cpu().numpy().astype(np.float32)
    tri_v_all = data.tri_v.cpu().numpy()
    tri_v = tri_v_all.astype(np.int64)[: meta.n_tris]
    t_pad = int(tri_v_all.shape[0])
    sph_c = verts[data.sphere_cvid.cpu().numpy().astype(np.int64)[: meta.n_spheres]]
    sph_r = data.sphere_rad.cpu().numpy().astype(np.float32)[: meta.n_spheres]

    n_tris, n_sph = meta.n_tris, meta.n_spheres
    n_prims = n_tris + n_sph
    if n_prims == 0:
        return BVH(
            box_min=np.zeros((1, 3), np.float32),
            box_max=np.zeros((1, 3), np.float32),
            skip=np.ones((1,), np.int32),
            leaf_start=np.zeros((1,), np.int32),
            leaf_count=np.zeros((1,), np.int32),
            axis=np.zeros((1,), np.int32),
            prim_idx=np.zeros((1,), np.int32),
        )

    # prims ordered tris-then-spheres so a stable partition keeps every
    # leaf's triangles ahead of its spheres
    tv = verts[tri_v]  # (n_tris, 3, 3)
    prim_min = np.concatenate([tv.min(axis=1), sph_c - sph_r[:, None]], axis=0)
    prim_max = np.concatenate([tv.max(axis=1), sph_c + sph_r[:, None]], axis=0)
    centers = np.concatenate([tv.mean(axis=1), sph_c], axis=0).astype(np.float32)
    prim_ids = np.concatenate(
        [np.arange(n_tris, dtype=np.int32), t_pad + np.arange(n_sph, dtype=np.int32)]
    )

    built = _build_native(prim_min, prim_max, centers, prim_ids)
    if built is not None:
        return built

    node_min, node_max, node_axis = [], [], []
    leaf_ranges = []  # (start, count) per node; (0, 0) for inner
    prim_order: list[np.ndarray] = []
    prim_cursor = 0

    def emit(idx_list: np.ndarray, depth: int) -> int:
        """Emit the subtree over prims ``idx_list`` in preorder; return size."""
        nonlocal prim_cursor
        my = len(node_min)
        bmin = prim_min[idx_list].min(axis=0)
        bmax = prim_max[idx_list].max(axis=0)
        node_min.append(bmin)
        node_max.append(bmax)
        node_axis.append(0)
        leaf_ranges.append((0, 0))

        def make_leaf():
            nonlocal prim_cursor
            leaf_ranges[my] = (prim_cursor, len(idx_list))
            prim_order.append(prim_ids[idx_list])
            prim_cursor += len(idx_list)
            return 1

        if len(idx_list) <= 1 or depth >= MAX_BVH_DEPTH:
            return make_leaf()

        ax = int(np.argmax(bmax - bmin))  # first max wins, like the reference
        node_axis[my] = ax
        start, end = np.float32(bmin[ax]), np.float32(bmax[ax])
        mid = np.float32((start + end) / 2)
        coords = centers[idx_list, ax]
        left_mask = coords < mid
        # at most 19 candidate midpoints: the first plus 18 bisections
        tries = SPLIT_RETRIES - 1
        while tries > 0 and (left_mask.all() or not left_mask.any()):
            tries -= 1
            if not left_mask.any():
                start = mid
            else:
                end = mid
            mid = np.float32((start + end) / 2)
            left_mask = coords < mid
        if left_mask.all() or not left_mask.any():
            return make_leaf()

        size_l = emit(idx_list[left_mask], depth + 1)
        size_r = emit(idx_list[~left_mask], depth + 1)
        return 1 + size_l + size_r

    emit(np.arange(n_prims), 0)
    n_nodes = len(node_min)

    leaf_count_arr = np.array([c for (_, c) in leaf_ranges], dtype=np.int32)
    skip = np.zeros(n_nodes, dtype=np.int32)

    def fill_skip(i: int) -> int:
        if leaf_count_arr[i] > 0:
            skip[i] = i + 1
            return i + 1
        j = fill_skip(i + 1)
        j = fill_skip(j)
        skip[i] = j
        return j

    fill_skip(0)
    return BVH(
        box_min=np.stack(node_min).astype(np.float32),
        box_max=np.stack(node_max).astype(np.float32),
        skip=skip,
        leaf_start=np.array([s for (s, _) in leaf_ranges], dtype=np.int32),
        leaf_count=leaf_count_arr,
        axis=np.array(node_axis, dtype=np.int32),
        prim_idx=np.concatenate(prim_order).astype(np.int32),
    )
