"""Primary (eye) ray generation (port of ``raytracer_tpu/ops/camera.py``).

The reference's EyeRayGenerator: ``w = -gaze`` (not normalized), ``v = up``
verbatim, ``u = v x w``; image-plane origin ``q = (e + gaze*near) + u*l +
v*t``; pixel (row, col) sampled at its center; the direction ``s - e`` is
left UNNORMALIZED (t along eye rays is in units of |s - e|).  Row 0 is
the top image row.

Sample jitter (the jitter and adaptive SSAA modes) comes from
``jitter_offsets``: a counter-based hash of (seed, stream, index, element)
in int64 tensor ops on the render's device.  Integer ops are exact, so a
seed gives the same offsets bit for bit, and the same image, on the CPU
and on CUDA, with no host draw or copy.  The JAX package draws with
``jax.random``, which PyTorch cannot reproduce: a seed gives another
(equally distributed) sample set there.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from raytracer_tpu_torch.models.scene import Camera
from raytracer_tpu_torch.ops.shade import cross


def camera_vectors(cam: Camera) -> np.ndarray:
    """The camera's numbers as one (5, 3) f32 array: position, gaze, up,
    (l, r, b) and (t, near_distance, 0)."""
    l, r, b, t = cam.near_plane
    return np.array(
        [cam.position, cam.gaze, cam.up, (l, r, b),
         (t, cam.near_distance, 0.0)], dtype=np.float32,
    )


def camera_basis_from(vec: torch.Tensor, width: int, height: int):
    """(e, u, v, q, su_mult, sv_mult) from a (5, 3) camera_vectors tensor."""
    e, gaze, v = vec[0], vec[1], vec[2]
    l, r, b = vec[3, 0], vec[3, 1], vec[3, 2]
    t, near = vec[4, 0], vec[4, 1]
    w = -gaze
    u = cross(v, w)
    m = e + gaze * near
    q = m + u * l + v * t
    # divisors as tensors on vec's device: PyTorch's CUDA kernels turn a
    # division by a host scalar into a multiply by its reciprocal
    su_mult = (r - l) / vec.new_tensor(width)
    sv_mult = (t - b) / vec.new_tensor(height)
    return e, u, v, q, su_mult, sv_mult


def eye_rays_from(vec: torch.Tensor, width: int, height: int):
    """(origin (3,), dirs (H*W, 3)) on ``vec``'s device, row-major."""
    e, u, v, q, su_mult, sv_mult = camera_basis_from(vec, width, height)
    dev = vec.device
    cols = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) * su_mult
    rows = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5) * sv_mult
    s = (
        q[None, None, :]
        + u[None, None, :] * cols[None, :, None]
        - v[None, None, :] * rows[:, None, None]
    )  # (H, W, 3)
    dirs = (s - e[None, None, :]).reshape(-1, 3)
    return e, dirs


def eye_rays_band(vec: torch.Tensor, width: int, height: int, row0: int,
                  band_h: int, jitter=None):
    """(origin (3,), dirs (band_h*W, 3)) for rows [row0, row0+band_h) of
    the (height, width) grid; without ``jitter`` equal bit for bit to
    those rows of ``eye_rays_from``.  Rows past ``height`` (a mesh's
    virtual pad rows) extrapolate the image plane.  ``jitter``: (band_h,
    W, 2) offsets in [-0.5, 0.5) of each sample from its pixel center (x,
    y)."""
    e, u, v, q, su_mult, sv_mult = camera_basis_from(vec, width, height)
    dev = vec.device
    cols = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    rows = torch.arange(band_h, dtype=torch.float32, device=dev) + row0 + 0.5
    if jitter is None:
        su = (cols * su_mult)[None, :]
        sv = (rows * sv_mult)[:, None]
    else:
        su = (cols[None, :] + jitter[..., 0]) * su_mult      # (band_h, W)
        sv = (rows[:, None] + jitter[..., 1]) * sv_mult
    s = (
        q[None, None, :]
        + u[None, None, :] * su[..., None]
        - v[None, None, :] * sv[..., None]
    )
    return e, (s - e[None, None, :]).reshape(-1, 3)


def eye_rays_pixels(vec: torch.Tensor, width: int, height: int, rows, cols,
                    jitter=None):
    """(origin (3,), dirs (N, 3)) for an arbitrary set of pixels: ``rows``
    and ``cols`` are (N,) f32 pixel coordinates, ``jitter`` optional (N, 2)
    offsets from the pixel centers (adaptive sampling's generator)."""
    e, u, v, q, su_mult, sv_mult = camera_basis_from(vec, width, height)
    su = cols + 0.5
    sv = rows + 0.5
    if jitter is not None:
        su = su + jitter[:, 0]
        sv = sv + jitter[:, 1]
    su = su * su_mult
    sv = sv * sv_mult
    s = q[None, :] + u[None, :] * su[:, None] - v[None, :] * sv[:, None]
    return e, s - e[None, :]


# one stream of offsets per use, so equal indices draw independent sets
JITTER_STREAMS = {"band": 0, "base": 1, "round": 2}

_M32 = 0xFFFFFFFF


def _mul32(x, m: int):
    """x * m mod 2**32 for x in [0, 2**32) (a Python int or an int64
    tensor) and a 32-bit constant m, in two 16-bit halves of m so that no
    product overflows int64."""
    return (x * (m & 0xFFFF) + (((x * (m >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """The lowbias32 integer hash (C. Wellons) of x in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def jitter_offsets(seed: int, key, shape, device="cpu") -> torch.Tensor:
    """f32 tensor of ``shape`` on ``device``, uniform in [-0.5, 0.5) on a
    2**-24 grid: element i is a hash of (``seed``, ``key``, i), with ``key
    = (stream, index)``: a streamed band is ``("band", row0)``, adaptive
    sampling's base wave ``("base", 0)`` and its refinement rounds
    ``("round", r)``.  Bit-identical on every device."""
    stream, index = key
    seed = int(seed)
    k = 0
    for word in (seed & _M32, (seed >> 32) & _M32, JITTER_STREAMS[stream],
                 int(index) & _M32):
        k = _mix32(k ^ word)
    k2 = _mix32(k ^ 0x9E3779B9)
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    x = _mix32(_mix32((i & _M32) ^ k) ^ (i >> 32) ^ k2)
    # the top 24 bits, centred: exact in f32
    return ((x >> 8) - (1 << 23)).to(torch.float32).mul_(2.0 ** -24).view(shape)


def draw_jitter(jitter, seed: int, key, shape, device) -> torch.Tensor:
    """The offsets of one draw on ``device``: ``jitter(key, shape)`` when the
    caller supplies arrays (tests inject the JAX package's draws), else
    ``jitter_offsets(seed, key, shape, device)``."""
    if jitter is None:
        return jitter_offsets(seed, key, tuple(shape), device)
    x = jitter(key, tuple(shape))
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, dtype=np.float32))
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"jitter for {key}: shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    return x.to(device=device, dtype=torch.float32)


def recorded_jitter(seed: int, device="cpu"):
    """(record, replay) ``jitter`` callables: ``record`` draws
    ``jitter_offsets(seed, ..., device)`` and keeps each array, ``replay``
    hands the kept arrays to a second render (the same samples on another
    device)."""
    drawn = {}

    def record(key, shape):
        drawn[key] = jitter_offsets(seed, key, shape, device)
        return drawn[key]
    return record, lambda key, shape: drawn[key]
