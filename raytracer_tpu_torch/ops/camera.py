"""Primary (eye) ray generation (port of ``raytracer_tpu/ops/camera.py``).

The reference's EyeRayGenerator: ``w = -gaze`` (not normalized), ``v = up``
verbatim, ``u = v x w``; image-plane origin ``q = (e + gaze*near) + u*l +
v*t``; pixel (row, col) sampled at its center; the direction ``s - e`` is
left UNNORMALIZED (t along eye rays is in units of |s - e|).  Row 0 is
the top image row.
"""

from __future__ import annotations

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
