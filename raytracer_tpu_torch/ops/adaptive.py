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

Every shape is fixed by the arguments (the base wave is (blocks,
base_spp), round r (k, its share of extra_spp), the selection a device
tensor), so the frame is one program on every engine (``_Adaptive``, the
counterpart of the JAX package's ``_adaptive_jit``), run as
``models.programs.render_programs`` chooses: kept and captured on a CUDA
device, made anew and run in place on the CPU, inside ``eager()`` and
under ``debug_nans()``.  The refinement waves' ``compact_mode="deep"``
gates the cluster engine's compaction only: brute and bvh never compact,
as in the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from raytracer_tpu_torch.models import programs
from raytracer_tpu_torch.models.scene import Camera, SceneData, SceneMeta
from raytracer_tpu_torch.models.whitted import (
    _cap_chunk_for_big_scenes, _Rays, _render_device, _tile_block_shape,
    nan_site, resolve_engine,
)
from raytracer_tpu_torch.ops.camera import (
    camera_vectors, draw_jitter, draw_jitter_into, eye_rays_pixels,
    write_jitter_keys,
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


def _wave_rays(vec, w: int, h: int, rows2, cols2, offs, tile: int,
               center_first: bool):
    """(origin (3,), dirs) of a wave over the (B, np) pixel coordinates
    ``rows2``, ``cols2`` with the offsets ``offs`` (B, spp, np, 2), laid
    out (block, sample group, sub-block, sample in group, pixel).  With
    ``center_first`` (the base wave) sample 0 is the pixel center."""
    b, spp, npx = offs.shape[:3]
    g = sample_group(spp)
    og, p = spp // g, tile // g
    sub = npx // p
    if center_first:
        offs = torch.cat([torch.zeros_like(offs[:, :1]), offs[:, 1:]], 1)
    offs = offs.reshape(b, og, g, sub, p, 2).permute(0, 1, 3, 2, 4, 5)
    rr = rows2.reshape(b, 1, sub, 1, p).expand(b, og, sub, g, p).reshape(-1)
    cc = cols2.reshape(b, 1, sub, 1, p).expand(b, og, sub, g, p).reshape(-1)
    return eye_rays_pixels(vec, w, h, rr, cc, jitter=offs.reshape(-1, 2))


def _wave_color(color, b: int, spp: int, npx: int, tile: int):
    """A wave's (B * spp * np, 3) radiance in ``_wave_rays``' layout ->
    (B, spp, np, 3)."""
    g = sample_group(spp)
    og, p = spp // g, tile // g
    color = color.reshape(b, og, npx // p, g, p, 3).permute(0, 1, 3, 2, 4, 5)
    return color.reshape(b, spp, npx, 3)


def _base_stats(base):
    """(color sum, luma sum, luma sum of squares) per pixel of the base
    wave's (nblk, spp, tile, 3) samples, in tile order."""
    lum = _luma(base)
    return base.sum(1), lum.sum(1), (lum * lum).sum(1)


def _score(lsum, lsq, counts):
    """Each block's mean luma variance from the running statistics."""
    c = counts[:, :, 0]
    var = lsq / c - torch.square(lsum / c)
    return torch.clamp_min(var, 0.0).mean(1)


def _add_samples(sum1, lsum, lsq, counts, sel, extra, spp: int) -> None:
    """Add a refinement wave's (k, spp, tile, 3) samples of the blocks
    ``sel`` to the running statistics (in place)."""
    lum_e = _luma(extra)
    sum1.index_add_(0, sel, extra.sum(1))
    lsum.index_add_(0, sel, lum_e.sum(1))
    lsq.index_add_(0, sel, (lum_e * lum_e).sum(1))
    counts[sel] += float(spp)


def _mean_image(sum1, counts, h: int, w: int, inv):
    """The (h, w, 3) mean radiance in row order: the blocks reshaped, or
    gathered by ``inv``, which drops the pad lanes too."""
    mean = (sum1 / counts).reshape(-1, 3)
    if inv is None:
        return from_blocks(mean, h, w, *_tile_block_shape()).reshape(h, w, 3)
    return mean[inv].reshape(h, w, 3)


class _Adaptive:
    """The adaptive frame of an (h, w) camera as a program of ``progs``
    (``models.programs.render_programs``: kept, or run in place), the
    counterpart of the JAX package's ``_adaptive_jit``.  Made once per
    scene and shape (when kept): the tile-ordered pixel coordinates and
    ``inv`` are uploaded then; the camera vector is copied into a static
    buffer before each run.  Each wave samples the
    offsets in its static jitter buffer: with ``drawn`` its prologue draws
    them (one threefry launch inside the program, as ``_adaptive_jit``
    draws), under the key words that each run writes into row i of the
    static ``keys`` ((1 + rounds, 2) int64: the base wave, then each
    round); otherwise a caller's ``jitter`` gives them, copied in before
    the wave.  Steps: the base prologue (the draw, eye rays into the base
    wave), the base wave's bounce steps (``_Rays`` on ``engine``,
    ``compact_mode="auto"``), the base epilogue (the running statistics);
    per round a prologue (score, ``stable_topk``, the draw, the chosen
    blocks' rays), the round wave's bounce steps (``"deep"``) and an
    epilogue (``_add_samples``); a final step (the mean, back to row order)
    into the static ``out``.  Every wave keeps its flags read between
    bounces, so the early exit and the compaction gate stay; a wave's steps
    run inside ``nan_site`` naming it."""

    def __init__(self, progs, data: SceneData, meta: SceneMeta, accel, h: int,
                 w: int, base_spp: int, per_round: tuple, k: int, bfc: bool,
                 relaxed: bool, device, engine: str = "cluster",
                 drawn: bool = False):
        bh, bw = _tile_block_shape()
        self.tile = tile = bh * bw
        self.h, self.w, self.base_spp, self.per_round = h, w, base_spp, per_round
        rows, cols, inv = _tile_pixel_coords(h, w, bh, bw)
        self.nblk = nblk = len(rows) // tile
        self.rows = torch.from_numpy(rows.astype(np.float32)).to(device).view(
            nblk, tile)
        self.cols = torch.from_numpy(cols.astype(np.float32)).to(device).view(
            nblk, tile)
        self.inv = None if inv is None else torch.from_numpy(inv).to(device)
        f32 = dict(dtype=torch.float32, device=device)
        self.vec = torch.zeros((5, 3), **f32)
        self.jitter = {("base", 0): torch.zeros((nblk, base_spp, tile, 2), **f32)}
        for rnd, spp in enumerate(per_round):
            self.jitter[("round", rnd)] = torch.zeros((k, spp, tile, 2), **f32)
        self.keys = (torch.zeros((1 + len(per_round), 2), dtype=torch.int64,
                                 device=device) if drawn else None)
        self.key_words = (None if self.keys is None
                          else list(self.keys.view(-1)))
        self.sum1 = torch.zeros((nblk, tile, 3), **f32)
        self.lsum = torch.zeros((nblk, tile), **f32)
        self.lsq = torch.zeros((nblk, tile), **f32)
        self.counts = torch.zeros((nblk, 1, 1), **f32)
        self.sel = torch.zeros((k,), dtype=torch.long, device=device)
        self.out = torch.zeros((h, w, 3), **f32)

        def rays(r, compact_mode):
            return _Rays(progs, data, meta, accel, r,
                         _cap_chunk_for_big_scenes(r, accel), True, bfc,
                         relaxed, compact_mode=compact_mode, device=device,
                         engine=engine)
        self.base = rays(nblk * base_spp * tile, "auto")
        self.waves = {spp: rays(k * spp * tile, "deep") for spp in set(per_round)}
        # the steps of each wave (its prologue draws into its jitter buffer)
        self.waves_steps = [(("base", 0), [
            progs.step("adaptive base prologue", self._base_prologue),
            self.base.run,
            progs.step("adaptive base epilogue", self._base_epilogue)])]
        for rnd, spp in enumerate(per_round):
            self.waves_steps.append((("round", rnd), [
                progs.step(f"adaptive round {rnd} prologue",
                           functools.partial(self._round_prologue, rnd)),
                self.waves[spp].run,
                progs.step(f"adaptive round {rnd} epilogue",
                           functools.partial(self._round_epilogue, rnd))]))
        self.final = progs.step("adaptive final", self._final)

    @torch.no_grad()
    def __call__(self, vec, jitter, seed: int) -> torch.Tensor:
        """The frame's (h, w, 3) mean radiance (the static ``out``: copy
        it before the next run) for camera vector ``vec``, each wave's
        jitter the draw of ``seed`` (drawn) or ``jitter``'s (given), as
        ``draw_jitter`` gives it."""
        if self.keys is not None:
            write_jitter_keys(self.key_words, seed,
                              [key for key, _ in self.waves_steps])
        self.vec.copy_(vec)
        for key, steps in self.waves_steps:
            if self.keys is None:
                buf = self.jitter[key]
                buf.copy_(draw_jitter(jitter, seed, key, buf.shape, buf.device))
            with nan_site(f"adaptive {key[0]} wave {key[1]}"):
                for step in steps:
                    step()
        self.final()
        return self.out

    def _base_prologue(self) -> None:
        if self.keys is not None:
            draw_jitter_into(self.keys[0], self.jitter[("base", 0)])
        self.base.load(*_wave_rays(self.vec, self.w, self.h, self.rows,
                                   self.cols, self.jitter[("base", 0)],
                                   self.tile, True))

    def _base_epilogue(self) -> None:
        base = _wave_color(self.base.color, self.nblk, self.base_spp,
                           self.tile, self.tile)
        for buf, x in zip((self.sum1, self.lsum, self.lsq), _base_stats(base)):
            buf.copy_(x)
        self.counts.fill_(float(self.base_spp))

    def _round_prologue(self, rnd: int) -> None:
        sel = stable_topk(_score(self.lsum, self.lsq, self.counts),
                          self.sel.shape[0])
        self.sel.copy_(sel)
        if self.keys is not None:
            draw_jitter_into(self.keys[1 + rnd], self.jitter[("round", rnd)])
        self.waves[self.per_round[rnd]].load(*_wave_rays(
            self.vec, self.w, self.h, self.rows[sel], self.cols[sel],
            self.jitter[("round", rnd)], self.tile, False))

    def _round_epilogue(self, rnd: int) -> None:
        spp = self.per_round[rnd]
        extra = _wave_color(self.waves[spp].color, self.sel.shape[0], spp,
                            self.tile, self.tile)
        _add_samples(self.sum1, self.lsum, self.lsq, self.counts, self.sel,
                     extra, spp)

    def _final(self) -> None:
        self.out.copy_(_mean_image(self.sum1, self.counts, self.h, self.w,
                                   self.inv))


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
    shape) -> array`` supplying the draws (see the module docstring).

    The frame is the ``_Adaptive`` of this scene, engine and shape from
    the render's programs (``programs.render_programs``): replayed on a
    CUDA device, run in place on the CPU, inside ``eager()`` and under
    ``debug_nans()``."""
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
    nblk = -(-(h * w) // tile)
    p_sel = tile                       # refinement unit: whole blocks
    nsel = nblk * tile // p_sel
    k = min(nsel, max(1, round(refine_frac * nsel))) if extra_spp > 0 else 0
    per_round = tuple(
        extra_spp // rounds + (1 if i < extra_spp % rounds else 0)
        for i in range(rounds)) if extra_spp > 0 else ()
    per_round = tuple(x for x in per_round if x > 0)
    vec = torch.from_numpy(camera_vectors(cam)).to(dev)
    progs = programs.render_programs(data, meta, accel, dev)
    drawn = jitter is None
    prog = progs.program(
        ("adaptive", engine, h, w, base_spp, per_round, k, bfc, relaxed,
         "drawn" if drawn else "given"),
        lambda: _Adaptive(progs, data, meta, accel, h, w, base_spp,
                          per_round, k, bfc, relaxed, dev, engine, drawn))
    img = prog(vec, jitter, seed).clone()
    extra_total = k * p_sel * sum(per_round)
    total = nblk * tile * base_spp + extra_total
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
    return img, stats

