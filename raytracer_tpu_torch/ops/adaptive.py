"""Adaptive (variance-driven) supersampling (port of
``raytracer_tpu/ops/adaptive.py``).

Every pixel gets ``base_spp`` samples (sample 0 at the pixel center, the
rest jittered); then each refinement round gives the pixel blocks with
the highest mean luma variance, re-scored from the accumulated sample
statistics, their share of ``extra_spp`` more fully jittered samples.

The unit of refinement is a pixel block of one kernel TILE (8x16), so a
refinement wave is a stack of coherent tile frustums.  Samples are
grouped so that every 128-ray run is one tight frustum: with g the
largest power-of-2 divisor of spp (at most 8), a run is a sub-block of
128/g pixels x g consecutive samples, and the rays of a wave are laid out
(block, sample group, sub-block, sample in group, pixel).

The jitter is the JAX package's (``ops.camera.draw_jitter``: with ``kb,
kr = split(PRNGKey(seed))`` the base wave ``("base", 0)`` draws from kb,
refinement round r ``("round", r)`` from kr, or fold_in(kr, r) for r > 0),
or comes from a caller's ``jitter(key, shape)``.  The top-k is a stable descending sort:
the k highest scores in descending order, ties to the lower block, as
``jax.lax.top_k`` orders them (a refinement wave's jitter is indexed by
that order).
"""

from __future__ import annotations

import numpy as np
import torch

from raytracer_tpu_torch.models.scene import Camera, SceneData, SceneMeta
from raytracer_tpu_torch.models.whitted import (
    _cap_chunk_for_big_scenes, _render_device, _tile_block_shape, eager,
    nan_site, resolve_engine, trace,
)
from raytracer_tpu_torch.ops.camera import (
    camera_vectors, draw_jitter, eye_rays_pixels,
)
from raytracer_tpu_torch.ops.tiling import block_permutation, divides, from_blocks

LUMA = (0.2126, 0.7152, 0.0722)  # Rec.709


def sample_group(spp: int) -> int:
    """Samples per 128-ray run: the largest power-of-2 divisor of spp,
    capped at 8."""
    g = 1
    while spp % (g * 2) == 0 and g < 8:
        g *= 2
    return g


def _tile_pixel_coords(h: int, w: int, bh: int, bw: int):
    """(rows, cols, inv or None) of the pixels in tile order, numpy.  A
    frame the blocks do not divide is padded to whole tiles with copies of
    its last pixel; ``inv`` takes tile order back to row order (None when
    ``from_blocks`` does)."""
    perm, inv = block_permutation(h, w, bh, bw)
    if divides(h, w, bh, bw):
        return perm // w, perm % w, None
    pad = (-(h * w)) % (bh * bw)
    perm = np.concatenate([perm, np.repeat(perm[-1:], pad)])
    return perm // w, perm % w, inv


def stable_topk(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k highest scores, highest first, equal scores in
    ascending index order (``jax.lax.top_k``'s order)."""
    return torch.sort(score, descending=True, stable=True).indices[:k]


def _luma(color: torch.Tensor) -> torch.Tensor:
    return color[..., 0] * LUMA[0] + color[..., 1] * LUMA[1] + color[..., 2] * LUMA[2]


def render_camera_adaptive(data: SceneData, meta: SceneMeta, cam: Camera,
                           accel, base_spp: int = 4,
                           extra_spp: int = 12, refine_frac: float = 0.125,
                           seed: int = 0, bfc: bool = False, rounds: int = 1,
                           relaxed: bool = False, device="cuda", jitter=None,
                           engine: str = "auto"):
    """Render one camera adaptively through ``engine`` (``resolve_engine``):
    ``(img, stats)`` with ``img`` the (H, W, 3) f32 mean radiance on
    ``device``.  ``rounds`` refinement
    passes each give the ``refine_frac`` noisiest blocks their exact share
    of ``extra_spp`` (earlier rounds take the remainder).  ``stats``
    records the budget spent.  ``jitter``: optional callable ``(key,
    shape) -> array`` supplying the draws (see the module docstring)."""
    if base_spp < 2:
        raise ValueError("adaptive sampling needs base_spp >= 2 "
                         "(variance of one sample is identically zero)")
    if rounds < 1:
        raise ValueError("rounds must be >= 1")
    if extra_spp > 0 and rounds > extra_spp:
        raise ValueError(
            f"rounds={rounds} exceeds extra_spp={extra_spp}: each round "
            "needs at least one sample (the budget is split exactly)")
    dev = _render_device(data, accel, device)
    engine = resolve_engine(engine, accel, meta)
    h, w = cam.height, cam.width
    bh, bw = _tile_block_shape()
    tile = bh * bw
    rows, cols, inv = _tile_pixel_coords(h, w, bh, bw)
    nblk = len(rows) // tile
    p_sel = tile                       # refinement unit: whole blocks
    nsel = len(rows) // p_sel
    k = min(nsel, max(1, round(refine_frac * nsel))) if extra_spp > 0 else 0
    per_round = tuple(
        extra_spp // rounds + (1 if i < extra_spp % rounds else 0)
        for i in range(rounds)) if extra_spp > 0 else ()
    per_round = tuple(x for x in per_round if x > 0)
    vec = torch.from_numpy(camera_vectors(cam)).to(dev)
    rows_t = torch.from_numpy(rows.astype(np.float32)).to(dev)
    cols_t = torch.from_numpy(cols.astype(np.float32)).to(dev)

    def wave(rows2, cols2, spp, key, center_first):
        """(B, np) pixel coords -> (B, spp, np, 3) per-sample radiance.
        With ``center_first`` (the base wave) sample 0 is the pixel
        center; refinement waves are fully jittered and compact with
        ``compact_mode="deep"``."""
        b, npx = rows2.shape
        g = sample_group(spp)
        og, p = spp // g, tile // g
        sub = npx // p
        offs = draw_jitter(jitter, seed, key, (b, spp, npx, 2), dev)
        if center_first:
            offs = torch.cat([torch.zeros_like(offs[:, :1]), offs[:, 1:]], 1)
        offs = offs.reshape(b, og, g, sub, p, 2).permute(0, 1, 3, 2, 4, 5)
        rr = rows2.reshape(b, 1, sub, 1, p).expand(b, og, sub, g, p).reshape(-1)
        cc = cols2.reshape(b, 1, sub, 1, p).expand(b, og, sub, g, p).reshape(-1)
        e, dirs = eye_rays_pixels(vec, w, h, rr, cc, jitter=offs.reshape(-1, 2))
        chunk = _cap_chunk_for_big_scenes(dirs.shape[0], accel)
        # eager: the waves' sizes follow the data (its captured program is
        # queued in ROADMAP.md)
        with nan_site(f"adaptive {key[0]} wave {key[1]}"), eager():
            color = trace(data, meta, e, dirs, accel, chunk, bfc=bfc,
                          relaxed=relaxed, engine=engine,
                          compact_mode="auto" if center_first else "deep")
        color = color.reshape(b, og, sub, g, p, 3).permute(0, 1, 3, 2, 4, 5)
        return color.reshape(b, spp, npx, 3)

    base = wave(rows_t.view(nblk, tile), cols_t.view(nblk, tile), base_spp,
                ("base", 0), True)
    lum = _luma(base)                                  # (nblk, spp, tile)
    # running per-pixel statistics in tile order: color sum, luma sum and
    # sum of squares, sample counts per refinement unit
    sum1 = base.sum(1).reshape(nsel, p_sel, 3)
    lsum = lum.sum(1).reshape(nsel, p_sel)
    lsq = (lum * lum).sum(1).reshape(nsel, p_sel)
    counts = torch.full((nsel, 1, 1), float(base_spp), device=dev)
    rows_u, cols_u = rows_t.view(nsel, p_sel), cols_t.view(nsel, p_sel)

    def score():
        c = counts[:, :, 0]
        var = lsq / c - torch.square(lsum / c)
        return torch.clamp_min(var, 0.0).mean(1)

    for rnd in range(len(per_round) if k > 0 else 0):
        sel = stable_topk(score(), k)
        extra = wave(rows_u[sel], cols_u[sel], per_round[rnd], ("round", rnd),
                     False)
        lum_e = _luma(extra)                           # (k, spp, p_sel)
        sum1.index_add_(0, sel, extra.sum(1))
        lsum.index_add_(0, sel, lum_e.sum(1))
        lsq.index_add_(0, sel, (lum_e * lum_e).sum(1))
        counts[sel] += float(per_round[rnd])
    mean = (sum1 / counts).reshape(-1, 3)              # tile order, padded
    if inv is None:
        img = from_blocks(mean, h, w, bh, bw)
    else:
        img = mean[torch.from_numpy(inv).to(dev)]      # drops pad lanes too
    extra_total = k * p_sel * sum(per_round)
    total = len(rows) * base_spp + extra_total
    stats = {
        "blocks": nblk,
        "refine_units": nsel,
        "refine_unit_px": p_sel,
        "refined_blocks": k,
        "rounds": len(per_round),
        "base_spp": base_spp,
        "extra_spp_per_round": per_round,
        "total_samples": total,
        "mean_spp": total / (h * w),
    }
    return img.reshape(h, w, 3), stats
