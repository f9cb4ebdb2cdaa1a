"""Quantization and SSAA resampling (port of ``raytracer_tpu/ops/image.py``).

- ``quantize``: clamp to [0, 255], then round half up (the reference's
  Vec3f::toPixel on non-negative values).
- ``downsample_parity``: box filter over ALREADY-QUANTIZED uint8 pixels
  with truncating integer division (the reference binary's SSAA).
- ``downsample_mean``: float box mean before quantization.
"""

from __future__ import annotations

import torch


def quantize(color: torch.Tensor) -> torch.Tensor:
    """(..., 3) float color -> (..., 3) uint8."""
    return torch.floor(torch.clamp(color, 0.0, 255.0) + 0.5).to(torch.uint8)


def downsample_parity(img: torch.Tensor, factor: int) -> torch.Tensor:
    """(H, W, 3) uint8 -> (H//f, W//f, 3) uint8 via truncating integer mean."""
    h, w, _ = img.shape
    nh, nw = h // factor, w // factor
    blocks = img[: nh * factor, : nw * factor].reshape(nh, factor, nw, factor, 3)
    sums = blocks.to(torch.int32).sum(dim=(1, 3))
    return (sums // (factor * factor)).to(torch.uint8)


def downsample_mean(color: torch.Tensor, factor: int) -> torch.Tensor:
    """(H, W, 3) float -> (H//f, W//f, 3) float via float box mean."""
    h, w, _ = color.shape
    nh, nw = h // factor, w // factor
    blocks = color[: nh * factor, : nw * factor].reshape(nh, factor, nw, factor, 3)
    return blocks.mean(dim=(1, 3))
