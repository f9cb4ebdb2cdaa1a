"""BVH: host-side build -> flat, skip-threaded struct-of-arrays.

Port of ``raytracer_tpu/models/bvh.py``.  The reference's recipe:
top-down, split on the WIDEST axis at the spatial MIDPOINT with up to 19
bisection retries toward the non-empty side; a node becomes a leaf at
<= 1 primitive, depth 19 or a failed split.  Nodes are in PREORDER and
carry a SKIP index (the next preorder node outside the subtree).  Leaves
reference a contiguous range of the reordered ``prim_idx`` (triangles
before spheres within a leaf).

``BVH`` holds host numpy arrays: the cluster build reads ``prim_idx``
(the preorder primitive sequence) on the host.  The BVH engine walks a
``DeviceBVH``, the one node thread per octant (``with_octant_threads``,
built only for that engine) or the plain preorder, as tensors on the
render's device (``device_bvh``, the one place that converts).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from raytracer_tpu_torch.models.scene import SceneData, SceneMeta, tensors_to

MAX_BVH_DEPTH = 19
SPLIT_RETRIES = 19


@dataclasses.dataclass(frozen=True)
class BVH:
    """Flat skip-threaded BVH (host numpy arrays).  Primitive ids encode
    triangles as [0, T_pad) and spheres as T_pad + s.

    The optional ``oct_*`` arrays are eight re-threaded copies of the node
    arrays, one per ray direction octant o = 4*(dx<0) + 2*(dy<0) + (dz<0),
    concatenated as blocks of N: block o's preorder visits the NEAR child
    of every inner node first for rays of that octant (left first iff
    dir[axis] >= 0), the reference's ordered descent without a stack.
    Block 0 is the plain preorder; skip values are global (offset o*N)."""

    box_min: np.ndarray      # (N, 3) f32
    box_max: np.ndarray      # (N, 3) f32
    skip: np.ndarray         # (N,)  i32, next preorder node outside this subtree
    leaf_start: np.ndarray   # (N,)  i32, into prim_idx; 0 for inner nodes
    leaf_count: np.ndarray   # (N,)  i32, 0 for inner nodes
    axis: np.ndarray         # (N,)  i32, split axis (inner nodes)
    prim_idx: np.ndarray     # (P,)  i32, reordered primitive ids
    oct_box_min: Optional[np.ndarray] = None      # (8N, 3) f32
    oct_box_max: Optional[np.ndarray] = None      # (8N, 3) f32
    oct_skip: Optional[np.ndarray] = None         # (8N,)  i32, global indices
    oct_leaf_start: Optional[np.ndarray] = None   # (8N,)  i32
    oct_leaf_count: Optional[np.ndarray] = None   # (8N,)  i32


@dataclasses.dataclass(frozen=True)
class DeviceBVH:
    """The node thread the BVH engine walks, as tensors on one device
    (``device_bvh``): the eight octant threads of a BVH that has them
    (``blocks`` 8, block o for rays of octant o), else its plain preorder
    (``blocks`` 1).  Boxes f32, indices int64, skip values global."""

    box_min: torch.Tensor     # (blocks*N, 3)
    box_max: torch.Tensor     # (blocks*N, 3)
    skip: torch.Tensor        # (blocks*N,)
    leaf_start: torch.Tensor  # (blocks*N,)
    leaf_count: torch.Tensor  # (blocks*N,)
    prim_idx: torch.Tensor    # (P,)
    n_nodes: int              # N
    blocks: int               # 8 or 1

    def to(self, device) -> "DeviceBVH":
        return tensors_to(self, device)


OCT_FIELDS = ("oct_box_min", "oct_box_max", "oct_skip", "oct_leaf_start",
              "oct_leaf_count")

# above this many nodes the octant threads (8x the node memory) are not
# built and the walk takes the plain preorder
_ORDERED_MAX_NODES = 200_000


def _octant_threads(bvh: BVH) -> BVH:
    """``bvh`` with the eight ordered-descent node threads (a vectorized
    host pass, O(8N))."""
    skip0 = bvh.skip.astype(np.int64)
    leaf_count = bvh.leaf_count.astype(np.int64)
    axis = bvh.axis.astype(np.int64)
    box_min = bvh.box_min.astype(np.float32)
    box_max = bvh.box_max.astype(np.float32)
    leaf_start = bvh.leaf_start.astype(np.int64)
    n = skip0.shape[0]
    size = skip0 - np.arange(n)          # subtree size per node
    inner = leaf_count == 0
    idx = np.arange(n)
    left = np.minimum(idx + 1, n - 1)
    right = np.where(inner, skip0[left], 0)

    obm, obx, osk, ols, olc = [], [], [], [], []
    for o in range(8):
        neg = np.array([(o >> 2) & 1, (o >> 1) & 1, o & 1], bool)
        swap = inner & neg[axis]
        first = np.where(swap, right, idx + 1)
        second = np.where(swap, idx + 1, right)
        newpos = np.zeros(n, np.int64)
        frontier = np.array([0], np.int64)
        while frontier.size:
            f = frontier[inner[frontier]]
            if f.size == 0:
                break
            fc, sc = first[f], second[f]
            newpos[fc] = newpos[f] + 1
            newpos[sc] = newpos[f] + 1 + size[fc]
            frontier = np.concatenate([fc, sc])
        inv = np.empty(n, np.int64)
        inv[newpos] = idx                 # old node at each new slot
        base = o * n
        obm.append(box_min[inv])
        obx.append(box_max[inv])
        osk.append((np.arange(n) + size[inv] + base).astype(np.int32))
        ols.append(leaf_start[inv].astype(np.int32))
        olc.append(leaf_count[inv].astype(np.int32))
    return dataclasses.replace(
        bvh,
        oct_box_min=np.concatenate(obm),
        oct_box_max=np.concatenate(obx),
        oct_skip=np.concatenate(osk),
        oct_leaf_start=np.concatenate(ols),
        oct_leaf_count=np.concatenate(olc),
    )


def with_octant_threads(bvh: BVH) -> BVH:
    """``bvh`` with the octant threads, when it has none and at most
    _ORDERED_MAX_NODES nodes (the BVH engine's build step)."""
    if bvh.oct_skip is not None or bvh.skip.shape[0] > _ORDERED_MAX_NODES:
        return bvh
    return _octant_threads(bvh)


def device_bvh(bvh: BVH, device) -> DeviceBVH:
    """The thread the BVH engine walks on ``device``: the octant threads
    when ``bvh`` has them, else the plain preorder."""
    pre = "" if bvh.oct_skip is None else "oct_"

    def box(name):
        return torch.from_numpy(
            getattr(bvh, pre + name).astype(np.float32)).to(device)

    def idx(x):
        return torch.from_numpy(x.astype(np.int64)).to(device)

    return DeviceBVH(
        box_min=box("box_min"), box_max=box("box_max"),
        skip=idx(getattr(bvh, pre + "skip")),
        leaf_start=idx(getattr(bvh, pre + "leaf_start")),
        leaf_count=idx(getattr(bvh, pre + "leaf_count")),
        prim_idx=idx(bvh.prim_idx), n_nodes=bvh.skip.shape[0],
        blocks=1 if bvh.oct_skip is None else 8)


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


def build_bvh(data: SceneData, meta: SceneMeta, ordered: bool = False) -> BVH:
    """Build on the host from the scene's tensors (read back to numpy);
    ``ordered`` attaches the octant threads (``with_octant_threads``)."""
    bvh = _build(data, meta)
    return with_octant_threads(bvh) if ordered else bvh


def _build(data: SceneData, meta: SceneMeta) -> BVH:
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


def validate_bvh(bvh: BVH, n_prims: int) -> None:
    """Structural invariants: every primitive appears in exactly one leaf;
    child boxes lie inside their parent's; skip pointers land inside
    [i+1, N].  Raises AssertionError on a violation."""
    prim_idx, counts, starts = bvh.prim_idx, bvh.leaf_count, bvh.leaf_start
    n = counts.shape[0]
    seen: list[int] = []
    for i in range(n):
        if counts[i] > 0:
            seen.extend(prim_idx[starts[i]: starts[i] + counts[i]].tolist())
    assert len(seen) == n_prims, (len(seen), n_prims)
    assert len(set(seen)) == n_prims
    skip = bvh.skip
    assert (skip >= np.arange(n) + 1).all()
    assert (skip <= n).all()
    bmin, bmax = bvh.box_min, bvh.box_max
    for i in range(n):
        if counts[i] == 0:  # inner: children are i+1 and skip[i+1]
            for ch in (i + 1, int(skip[i + 1])):
                assert (bmin[ch] >= bmin[i] - 1e-5).all()
                assert (bmax[ch] <= bmax[i] + 1e-5).all()
