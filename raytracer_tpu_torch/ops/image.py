"""Quantization and SSAA resampling (port of ``raytracer_tpu/ops/image.py``).

- ``quantize``: clamp to [0, 255], then round half up (the reference's
  Vec3f::toPixel on non-negative values).
- ``downsample_parity``: box filter over ALREADY-QUANTIZED uint8 pixels
  with truncating integer division (the reference binary's SSAA).
- ``downsample_mean``: float box mean before quantization.
- ``tone_map``: a global tone curve on linear radiance, then quantize.
"""

from __future__ import annotations

import torch

TONE_MODES = ("none", "gamma", "reinhard", "aces")


def quantize(color: torch.Tensor) -> torch.Tensor:
    """(..., 3) float color -> (..., 3) uint8."""
    return torch.floor(torch.clamp(color, 0.0, 255.0) + 0.5).to(torch.uint8)


def tone_map(color: torch.Tensor, mode: str = "none") -> torch.Tensor:
    """(..., 3) linear float radiance (the reference's 0-255 scale) ->
    uint8: the curve runs on x = max(color, 0) / 255, then the result is
    scaled back and quantized.  ``none`` is plain quantize; ``gamma`` x **
    (1/2.2); ``reinhard`` x / (1 + x); ``aces`` Narkowicz's ACES fit
    (x (2.51 x + 0.03)) / (x (2.43 x + 0.59) + 0.14)."""
    if mode == "none":
        return quantize(color)
    # a tensor divisor: PyTorch's CUDA kernels turn a division by a host
    # scalar into a multiply by its reciprocal, the CPU's do not
    x = torch.clamp_min(color, 0.0) / color.new_tensor(255.0)
    if mode == "gamma":
        y = x ** (1.0 / 2.2)
    elif mode == "reinhard":
        y = x / (1.0 + x)
    elif mode == "aces":
        y = (x * (2.51 * x + 0.03)) / (x * (2.43 * x + 0.59) + 0.14)
    else:
        raise ValueError(f"unknown tone mode: {mode!r}")
    return quantize(y * 255.0)


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
