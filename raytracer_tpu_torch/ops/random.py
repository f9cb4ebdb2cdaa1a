"""The port's copy of JAX's default PRNG key algebra.

JAX draws with ``threefry2x32`` in its partitionable form
(``jax_threefry_partitionable``, the default): pure 32-bit integer
arithmetic, so the port reproduces ``jax.random`` bit for bit.

- ``prng_key(seed)`` is ``jax.random.PRNGKey(seed)``: ``(0, seed mod
  2**32)`` for any seed that fits int64 (others raise OverflowError, as
  JAX does).
- ``fold_in(key, data)`` hashes the counter ``(0, data)`` under ``key``.
- ``split(key)`` hashes the counters ``(0, 0)`` and ``(0, 1)``.
- ``uniform(key, shape, lo, hi, device)``: element i (row-major) hashes
  the counter ``(i >> 32, i & 0xFFFFFFFF)``; the xor of the two words
  gives the float's bits (``ops.kernels.threefry_uniform``: the CUDA
  kernel ``csrc/threefry.cu`` on the card, the plain version on the CPU).
- A captured program draws into its own buffer under key words that it
  reads from device memory (``ops.kernels.threefry_uniform_keyed``,
  through ``ops.camera.draw_jitter_into``).

Keys are pairs of Python ints; the key algebra runs on the host.
"""

from __future__ import annotations

import math

import torch

from raytracer_tpu_torch.backend import resolve_device
from raytracer_tpu_torch.ops import kernels

_M32 = 0xFFFFFFFF


def prng_key(seed: int) -> tuple:
    """``jax.random.PRNGKey(seed)`` as (k0, k1)."""
    seed = int(seed)
    if not -(1 << 63) <= seed < 1 << 63:
        raise OverflowError(f"seed {seed} does not fit int64")
    return 0, seed & _M32


def fold_in(key, data: int) -> tuple:
    """``jax.random.fold_in(key, data)`` for a 32-bit ``data``."""
    return kernels.threefry2x32(key, 0, int(data) & _M32)


def split(key) -> tuple:
    """``jax.random.split(key)``: the two subkeys."""
    return kernels.threefry2x32(key, 0, 0), kernels.threefry2x32(key, 0, 1)


def uniform(key, shape, lo: float = 0.0, hi: float = 1.0,
            device="cuda") -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, lo, hi)`` as an f32
    tensor on ``device``, bit for bit."""
    shape = tuple(int(s) for s in shape)
    return kernels.threefry_uniform(key[0], key[1], math.prod(shape), lo, hi,
                                    resolve_device(device)).view(shape)
