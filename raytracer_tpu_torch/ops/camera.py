"""Primary (eye) ray generation (port of ``raytracer_tpu/ops/camera.py``).

The reference's EyeRayGenerator: ``w = -gaze`` (not normalized), ``v = up``
verbatim, ``u = v x w``; image-plane origin ``q = (e + gaze*near) + u*l +
v*t``; pixel (row, col) sampled at its center; the direction ``s - e`` is
left UNNORMALIZED (t along eye rays is in units of |s - e|).  Row 0 is
the top image row.

Sample jitter (the jitter and adaptive SSAA modes) comes from
``draw_jitter``: the JAX package's ``jax.random`` draws, keyed as it keys
them, through ``ops.random`` (threefry2x32, the CUDA kernel
``csrc/threefry.cu`` on the card).  Integer arithmetic is exact, so a seed
gives the JAX package's sample set bit for bit, and the same image on the
CPU and on CUDA.  A captured program draws inside itself instead
(``draw_jitter_into``): the host writes the draw's key words
(``write_jitter_keys``) into a static tensor that the kernel reads.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracer_tpu_torch.backend import resolve_device
from raytracer_tpu_torch.models.scene import Camera
from raytracer_tpu_torch.ops import kernels, random
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
    # division by a host scalar into a multiply by its reciprocal; filled
    # on the device (no host copy), so a CUDA graph can capture them
    su_mult = (r - l) / vec.new_full((), width)
    sv_mult = (t - b) / vec.new_full((), height)
    return e, u, v, q, su_mult, sv_mult


def camera_basis(cam: Camera, device="cuda"):
    """(e, u, v, q, su_mult, sv_mult) of ``cam`` as f32 tensors on
    ``device``."""
    vec = torch.from_numpy(camera_vectors(cam)).to(resolve_device(device))
    return camera_basis_from(vec, cam.width, cam.height)


def eye_rays(cam: Camera, device="cuda"):
    """Eye rays of the full pixel grid on ``device``: origin (3,), the
    shared camera position, and dirs (H*W, 3), unnormalized, row-major,
    row 0 the top row."""
    vec = torch.from_numpy(camera_vectors(cam)).to(resolve_device(device))
    return eye_rays_from(vec, cam.width, cam.height)


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
    those rows of ``eye_rays_from``.  ``row0``: an int, or a 0-dim f32
    tensor on ``vec``'s device holding it (the band program's input; the
    same float32 sums).  Rows past ``height`` (a mesh's
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


def draw_jitter(jitter, seed: int, key, shape, device) -> torch.Tensor:
    """The offsets in [-0.5, 0.5) of one draw on ``device``, keyed as the
    JAX package keys its ``jax.random`` draws: a streamed band ``("band",
    row0)`` draws ``uniform(fold_in(PRNGKey(seed), row0))``, where the
    seed must lie in [0, 2**32) (JAX's ``jnp.uint32(seed)``; OverflowError
    else); with ``kb, kr = split(PRNGKey(seed))``, adaptive sampling's
    base wave ``("base", 0)`` draws ``uniform(kb)`` and its refinement
    round r ``("round", r)`` draws ``uniform(kr)`` for r = 0, else
    ``uniform(fold_in(kr, r))``.  ``jitter(key, shape)``, when given,
    supplies the arrays instead (a recorded draw replayed on another
    device, or a test's own)."""
    shape = tuple(shape)
    if jitter is None:
        return random.uniform(jitter_key(seed, key), shape, -0.5, 0.5, device)
    x = jitter(key, shape)
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, dtype=np.float32))
    if tuple(x.shape) != shape:
        raise ValueError(f"jitter for {key}: shape {tuple(x.shape)}, "
                         f"expected {shape}")
    return x.to(device=device, dtype=torch.float32)


def draw_jitter_into(key: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``draw_jitter``'s offsets into the buffer ``out`` under the key
    words that ``key`` ((2,) int64 on ``out``'s device, written through
    ``write_jitter_keys``) holds: read on the device, so a captured program
    replays the draw of the key written before the replay."""
    return kernels.threefry_uniform_keyed(key, out, -0.5, 0.5)


def write_jitter_keys(words, seed: int, draws) -> None:
    """Write the threefry key words of the draws ``draws`` under ``seed``
    (``jitter_key``; a band's seed out of [0, 2**32) raises OverflowError
    before anything is written) through ``words``, the 0-dim views of an
    int64 key tensor's words (draw i's at 2i and 2i + 1; a program makes
    them once, as a view is a host op), one ``fill_`` each: a kernel launch
    on the device's stream with the word as its argument, so it lands
    before a later replay and nothing waits for the stream (a blocking copy
    from host memory would; a reused pinned source would race)."""
    values = [v for d in draws for v in jitter_key(seed, d)]
    for word, value in zip(words, values, strict=True):
        word.fill_(value)


def jitter_key(seed: int, key) -> tuple:
    """The threefry key of draw ``key`` under ``seed`` (``draw_jitter``)."""
    stream, index = key
    if stream == "band":
        seed = int(seed)
        if not 0 <= seed < 1 << 32:
            raise OverflowError(f"seed {seed} out of bounds for uint32 (the "
                                "streamed route's seed, as in the JAX package)")
        return random.fold_in(random.prng_key(seed), index)
    kb, kr = random.split(random.prng_key(seed))
    if stream == "base":
        return kb
    return kr if index == 0 else random.fold_in(kr, index)   # "round"


def recorded_jitter(seed: int, device="cpu"):
    """(record, replay) ``jitter`` callables: ``record`` draws each array
    on ``device`` (``draw_jitter`` without injection) and keeps it,
    ``replay`` hands the kept arrays to a second render (the same samples
    on another device)."""
    drawn = {}

    def record(key, shape):
        drawn[key] = draw_jitter(None, seed, key, shape, device)
        return drawn[key]
    return record, lambda key, shape: drawn[key]
