"""One camera -> one image (port of ``raytracer_tpu/pipeline.py``): the
route of a render request (adaptive sampling, or row bands of about the
ray chunk), then the SSAA reduction, tone curve and quantization, with
the same semantics on both routes, through the brute, BVH or cluster
engine, on one device or split over a device mesh (``parallel.mesh``).

Spans (``tracing``, while a profiler records): ``pipeline.frame`` around
``render_one_camera``, ``pipeline.to_host`` around the image's copy to
the host, ``pipeline.write`` around ``write_image``; the bands' spans are
``render_camera_streamed``'s."""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from raytracer_tpu_torch import tracing
from raytracer_tpu_torch.backend import resolve_device
from raytracer_tpu_torch.models.whitted import (
    _tile_block_shape, render_camera_streamed, resolve_engine,
)
from raytracer_tpu_torch.ops.adaptive import render_camera_adaptive
from raytracer_tpu_torch.ops.image import TONE_MODES, quantize, tone_map

SSAA_MODES = ("parity", "mean", "jitter", "adaptive")
FORMATS = ("ppm", "png", "exr")


def render_one_camera(data, meta, cam, accel, *, ssaa: int = 1,
                      ssaa_mode: str = "parity", bfc: bool = False,
                      chunk: int = 1 << 22, tone: str = "none",
                      hdr: bool = False, seed: int = 0,
                      adaptive_frac: float = 0.125,
                      adaptive_extra: Optional[int] = None,
                      adaptive_rounds: int = 1, relaxed: bool = False,
                      device="cuda", engine: str = "auto", mesh=None,
                      ) -> Tuple[np.ndarray, Optional[dict]]:
    """Render ``cam`` at its declared resolution through ``engine``
    (``auto``: cluster for a ClusterSet ``accel``, bvh for a BVH over more
    than 64 primitives, else brute): ``(img, adaptive_stats)``.

    ``img`` is (H, W, 3) uint8, or f32 linear radiance when ``hdr`` (the
    EXR path; ``tone`` is then ignored).  ``adaptive_stats`` is None
    except in adaptive mode.  ``ssaa_mode``: ``parity`` averages the
    QUANTIZED samples with truncating integer division (the reference
    binary); ``mean`` averages radiance, then quantizes; ``jitter`` is
    ``mean`` over jittered samples (row bands, each band's offsets drawn
    from ``seed``); ``adaptive`` gives every pixel max(2, ssaa^2) samples
    and the noisiest ``adaptive_frac`` of pixel blocks ``adaptive_extra``
    (default 3x that) more, over ``adaptive_rounds`` rounds.  Every other
    request renders row bands of about ``chunk`` rays (after SSAA;
    ``render_camera_streamed``), one band when the frame, its rows rounded
    up to lcm(16, ssaa), fits.  Unknown mode strings raise ValueError.

    ``mesh`` (``parallel.mesh.Mesh``, its first device ``device``): the
    bands' rays are split over its shards and gathered across processes,
    so every rank returns the whole image, bit for bit the single-device
    one in the deterministic modes.  The mesh is dropped, as in the JAX
    package, when it has one shard, in adaptive mode (its refinement waves
    are small and data-dependent) and when the scaled width is not a
    multiple of the cluster engine's 16-pixel block (a shard would split
    blocks).  Jitter is keyed on the band rows, so a jittered image
    depends on the mesh's band heights (the JAX mesh path's)."""
    if ssaa_mode not in SSAA_MODES:
        raise ValueError(f"unknown ssaa_mode {ssaa_mode!r}; one of {SSAA_MODES}")
    if tone not in TONE_MODES:
        raise ValueError(f"unknown tone {tone!r}; one of {TONE_MODES}")
    with tracing.span("pipeline.frame", ssaa_mode):
        device = resolve_device(device)
        want_float = hdr or tone != "none"
        stats = None
        if mesh is not None:
            cluster = resolve_engine(engine, accel, meta) == "cluster"
            block_w = _tile_block_shape()[1] if cluster else 1
            if (mesh.size == 1 or ssaa_mode == "adaptive"
                    or (cam.width * ssaa) % block_w):
                mesh = None
        if ssaa_mode == "adaptive":
            # variance needs >= 2 samples: at ssaa 1 adaptive still
            # supersamples
            base = max(2, ssaa * ssaa)
            extra = adaptive_extra if adaptive_extra is not None else 3 * base
            color, stats = render_camera_adaptive(
                data, meta, cam, accel, base_spp=base, extra_spp=extra,
                refine_frac=adaptive_frac, seed=seed, bfc=bfc,
                rounds=adaptive_rounds, relaxed=relaxed, device=device,
                engine=engine)
            img = (color if hdr else tone_map(color, tone) if want_float
                   else quantize(color))
        else:
            # row bands: ray state stays about one chunk, the SSAA
            # reduction runs per band, and jittered samples are drawn per
            # band
            img = render_camera_streamed(
                data, meta, cam, accel, chunk=chunk, bfc=bfc, ssaa=ssaa,
                ssaa_mode=ssaa_mode, hdr=want_float, seed=seed,
                relaxed=relaxed, device=device, engine=engine, mesh=mesh)
            if want_float and not hdr:
                img = tone_map(img, tone)
        with tracing.span("pipeline.to_host"):
            return img.cpu().numpy(), stats


def write_image(out_dir: str, image_name: str, img: np.ndarray,
                fmt: str = "ppm") -> str:
    """Write ``img`` under ``out_dir`` in ``fmt``; returns the path.
    ``image_name`` is the scene's declared name; png and exr swap its
    extension."""
    if fmt not in FORMATS:
        raise ValueError(f"unknown format {fmt!r}; one of {FORMATS}")
    with tracing.span("pipeline.write", fmt):
        stem = image_name.rsplit(".", 1)[0]
        if fmt == "png":
            from raytracer_tpu_torch.utils.png import write_png

            path = os.path.join(out_dir, f"{stem}.png")
            write_png(path, img)
        elif fmt == "exr":
            from raytracer_tpu_torch.utils.exr import write_exr

            path = os.path.join(out_dir, f"{stem}.exr")
            write_exr(path, img)
        else:
            from raytracer_tpu_torch.utils.ppm import write_ppm

            path = os.path.join(out_dir, image_name)
            write_ppm(path, img)
        return path
