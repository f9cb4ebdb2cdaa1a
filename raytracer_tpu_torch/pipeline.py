"""One camera -> one image (port of the whole-frame branch of
``raytracer_tpu/pipeline.py``): render, SSAA reduction, quantization."""

from __future__ import annotations

import os

import numpy as np

from raytracer_tpu_torch.backend import resolve_device
from raytracer_tpu_torch.models.whitted import render_camera
from raytracer_tpu_torch.ops.image import (
    downsample_mean, downsample_parity, quantize,
)

SSAA_MODES = ("parity", "mean")


def render_one_camera(data, meta, cam, accel, *, ssaa: int = 1,
                      ssaa_mode: str = "parity", bfc: bool = False,
                      chunk: int = 1 << 22, relaxed: bool = False,
                      device="cuda") -> np.ndarray:
    """(H, W, 3) uint8 image of ``cam`` at its declared resolution.

    ``ssaa_mode``: ``parity`` averages the QUANTIZED samples with
    truncating integer division (the reference binary); ``mean`` averages
    radiance, then quantizes.  Other modes of the JAX package (jitter,
    adaptive) are not ported and raise ValueError.  A frame of more than
    ``chunk`` rays (after SSAA) takes the JAX package's streamed band
    renderer, which is not ported: NotImplementedError."""
    if ssaa_mode not in SSAA_MODES:
        raise ValueError(f"unknown or unported ssaa_mode {ssaa_mode!r}; "
                         f"one of {SSAA_MODES}")
    device = resolve_device(device)
    rcam = cam.scaled(ssaa) if ssaa > 1 else cam
    if rcam.width * rcam.height > chunk:
        raise NotImplementedError(
            f"{rcam.width * rcam.height} rays exceed chunk={chunk}: frames "
            "beyond one chunk take the streamed band renderer, ROADMAP "
            "queue 1 row 11")
    color = render_camera(data, meta, rcam, accel, chunk=chunk, bfc=bfc,
                          relaxed=relaxed, device=device)
    if ssaa <= 1:
        img = quantize(color)
    elif ssaa_mode == "parity":
        img = downsample_parity(quantize(color), ssaa)
    else:
        img = quantize(downsample_mean(color, ssaa))
    return img.cpu().numpy()


def write_image(out_dir: str, image_name: str, img: np.ndarray) -> str:
    """Write ``img`` as the scene's declared PPM under ``out_dir``; returns
    the path."""
    from raytracer_tpu_torch.utils.ppm import write_ppm

    path = os.path.join(out_dir, image_name)
    write_ppm(path, img)
    return path
