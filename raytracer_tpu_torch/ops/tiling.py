"""Pixel-tile ray ordering (port of ``raytracer_tpu/ops/tiling.py``).

The cluster engine culls per TILE of 128 consecutive rays, so rays are
re-ordered into 8x16 pixel blocks (a compact frustum each): a reshape and
permute when the block shape divides the frame, else a gather through a
host-computed permutation.  Shading is elementwise over rays, so the
order is invisible in the image.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def divides(h: int, w: int, bh: int, bw: int) -> bool:
    """True when the (h, w) grid tiles evenly into (bh, bw) blocks."""
    return h % bh == 0 and w % bw == 0


def to_blocks(x: torch.Tensor, h: int, w: int, bh: int, bw: int) -> torch.Tensor:
    """Row-major (h*w, ...) -> block order."""
    lead = tuple(x.shape[1:])
    y = x.reshape(h // bh, bh, w // bw, bw, *lead)
    y = y.permute((0, 2, 1, 3) + tuple(range(4, 4 + len(lead))))
    return y.reshape((h * w,) + lead)


def from_blocks(x: torch.Tensor, h: int, w: int, bh: int, bw: int) -> torch.Tensor:
    """Inverse of :func:`to_blocks` (block order -> row-major)."""
    lead = tuple(x.shape[1:])
    y = x.reshape(h // bh, w // bw, bh, bw, *lead)
    y = y.permute((0, 2, 1, 3) + tuple(range(4, 4 + len(lead))))
    return y.reshape((h * w,) + lead)


def apply_tile_order(x, h: int, w: int, blocks, perm):
    """Row-major -> tile order: reshape/permute when ``blocks=(bh, bw)``,
    else a ``perm`` gather, else identity."""
    if blocks is not None:
        return to_blocks(x, h, w, *blocks)
    if perm is not None:
        return x[perm]
    return x


def undo_tile_order(x, h: int, w: int, blocks, inv):
    """Tile order -> row-major (inverse of :func:`apply_tile_order`)."""
    if blocks is not None:
        return from_blocks(x, h, w, *blocks)
    if inv is not None:
        return x[inv]
    return x


@functools.lru_cache(maxsize=64)
def block_permutation(h: int, w: int, bh: int, bw: int):
    """(perm, inv) int64 numpy arrays of length h*w: ``perm[i]`` is the
    row-major pixel of the i-th ray in block order and ``x[perm][inv] ==
    x``.  Edge blocks may be partial."""
    rows = np.arange(h)
    cols = np.arange(w)
    rr, cc = np.meshgrid(rows, cols, indexing="ij")
    key = (
        (rr // bh).astype(np.int64) * ((w + bw - 1) // bw) + (cc // bw)
    ) * (h * w) + (rr % bh) * bw + (cc % bw)
    perm = np.argsort(key.reshape(-1), kind="stable").astype(np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(h * w, dtype=np.int64)
    return perm, inv
