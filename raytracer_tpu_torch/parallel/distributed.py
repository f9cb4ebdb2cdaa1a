"""Processes: ``torch.distributed`` bring-up and the image gather (port
of ``raytracer_tpu/parallel/distributed.py``).

Each process drives its own shards of the mesh (``parallel.mesh``); the
only data that crosses processes is the gather of each band's (or
frame's) radiance and, in training, the all-reduce of the loss and the
gradients.

- ``initialize()`` brings up the process group from its arguments or
  from torchrun's environment (``MASTER_ADDR``/``MASTER_PORT``, ``RANK``,
  ``WORLD_SIZE``).  Without either it is a no-op, so one entry point runs
  on a laptop, one card or many.  Unlike the JAX package, a bring-up that
  is configured and fails raises: falling back to one process would leave
  every process rendering and writing the whole image.
- The backend is NCCL when every process of a host has a card of its
  own, else gloo (NCCL refuses two processes on one card, and the CPU
  has no NCCL).  Gloo's collectives run on host copies.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from raytracer_tpu_torch.parallel.mesh import local_rank


# how long a collective waits for the other ranks before it fails
_TIMEOUT = datetime.timedelta(minutes=10)


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None) -> int:
    """Bring up ``torch.distributed``; returns this process's rank.
    ``init_method`` (``tcp://host:port``, ``file:///path``) with
    ``world_size`` and ``rank``, else ``env://`` from torchrun's variables.
    A no-op returning 0 when neither is given, and the rank when the group
    is already up.  Raises when a configured bring-up fails."""
    if dist.is_initialized():
        return dist.get_rank()
    env = os.environ
    if init_method is None and "MASTER_ADDR" not in env:
        return 0
    world_size = int(env["WORLD_SIZE"] if world_size is None else world_size)
    rank = int(env["RANK"] if rank is None else rank)
    per_host = int(env.get("LOCAL_WORLD_SIZE", world_size))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    backend = "nccl" if cards >= per_host else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank(rank))
    try:
        dist.init_process_group(
            backend, init_method=init_method or "env://",
            world_size=world_size, rank=rank, timeout=_TIMEOUT)
    except Exception as e:
        raise RuntimeError(f"torch.distributed bring-up failed (rank {rank} "
                           f"of {world_size}, {backend}): {e}") from e
    return rank


def _on_wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` where the backend's collectives take it: the card for NCCL,
    a host copy for gloo."""
    return x if dist.get_backend() == "nccl" else x.cpu()


def gather_rows(local: torch.Tensor, mesh=None) -> torch.Tensor:
    """The processes' equal ``local`` slices (this process's shards,
    concatenated) in rank order, on ``local``'s device.  With one process,
    ``local`` itself."""
    if mesh is None or mesh.world == 1:
        return local
    x = _on_wire(local.contiguous())
    parts = [torch.empty_like(x) for _ in range(mesh.world)]
    dist.all_gather(parts, x)
    return torch.cat(parts).to(local.device)


def all_mean(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """``x`` made the mean of the processes' ``x``, in place (a captured
    step's buffers stay put), and returned: an all-reduce of the SUM over
    the world (gloo has no AVG), then the division by the world where the
    collective ran (the host copy on gloo), identical on every rank; with
    one process ``x`` is left as it is."""
    if mesh is None or mesh.world == 1:
        return x
    y = _on_wire(x.detach())
    dist.all_reduce(y, op=dist.ReduceOp.SUM)
    y.div_(mesh.world)
    if y.device != x.device:
        x.detach().copy_(y)
    return x


def assemble_image(local: torch.Tensor, mesh=None) -> np.ndarray:
    """The full host array from this process's slice: with one process a
    plain device-to-host copy, else an all-gather, so that every rank
    holds the whole image (the CLIs write it on rank 0 only)."""
    return gather_rows(local, mesh).cpu().numpy()
