"""The device mesh (port of ``raytracer_tpu/parallel/mesh.py``).

One logical axis, the rays: ray tracing has no cross-ray communication
until the image gather, so a mesh is a flat list of shards, each tracing
an equal contiguous slice of a wavefront's (tile-ordered) ray axis.

A ``Mesh`` holds the shard devices of THIS process and its place in the
``torch.distributed`` process group: shard ``rank * len(devices) + i`` of
the ``size = world * len(devices)`` shards is ``devices[i]`` of process
``rank``.  A list may repeat a device: shards on one device are logical
(the analog of the JAX package's forced host device count), traced one
after another.  Shards of one process run one after another; a real
multi-card run gives each card a process of its own (torchrun), and the
shards of the processes run side by side.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import torch

from raytracer_tpu_torch.backend import resolve_device
from raytracer_tpu_torch.models import programs


@dataclasses.dataclass(frozen=True)
class Mesh:
    devices: Tuple[torch.device, ...]   # this process's shards, in order
    rank: int = 0                       # this process in the process group
    world: int = 1                      # processes in the group

    @property
    def size(self) -> int:
        """Shards of the whole mesh, over every process."""
        return self.world * len(self.devices)


def process_group() -> Tuple[int, int]:
    """(rank, world) of ``torch.distributed``; (0, 1) when it is not up."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_rank(rank: int) -> int:
    """This process's index among the processes of its host: torchrun's
    ``LOCAL_RANK``, else ``rank`` (one host)."""
    return int(os.environ.get("LOCAL_RANK", rank))


def local_cards() -> list:
    """The CUDA cards of this process: every card with one process, else
    card ``LOCAL_RANK`` (modulo the cards: processes may share one)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    rank, world = process_group()
    if world == 1 or n == 0:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cuda", local_rank(rank) % n)]


def make_mesh(devices: Optional[Sequence] = None,
              n: Optional[int] = None) -> Mesh:
    """A mesh over ``devices`` (default: ``local_cards()``), truncated to
    the first ``n``; a list may repeat a device (logical shards)."""
    devices = local_cards() if devices is None else list(devices)
    if n is not None:
        if len(devices) < n:
            raise ValueError(f"need {n} devices, have {len(devices)}")
        devices = devices[:n]
    if not devices:
        raise ValueError("need 1 devices, have 0")
    rank, world = process_group()
    return Mesh(tuple(resolve_device(d) for d in devices), rank, world)


def mesh_from_arg(arg: str = "auto", device="cuda") -> Optional[Mesh]:
    """The CLIs' ``--mesh``: ``auto`` is every card of this process, an
    integer N the first N shards of the whole mesh over every process (N
    a multiple of the process count; each process takes N / world of its
    cards, raising when it has fewer).  On ``device="cpu"``, ``auto`` is
    one shard a process and N gives each process N / world logical shards
    of the CPU.  None when the mesh would have one shard (callers then
    take their single-device path)."""
    dev = resolve_device(device)
    _, world = process_group()
    if arg == "auto":
        devices = [dev] if dev.type == "cpu" else local_cards()
    else:
        n = int(arg)
        if n < 1 or n % world:
            raise ValueError(f"--mesh {n} is not a multiple of the {world} "
                             "processes")
        k = n // world
        devices = [dev] * k if dev.type == "cpu" else local_cards()[:k]
        if len(devices) < k:
            raise ValueError(f"need {k} devices, have {len(devices)}")
    mesh = make_mesh(devices)
    return mesh if mesh.size > 1 else None


def shard_rays(mesh: Mesh, x: torch.Tensor) -> list:
    """This process's equal contiguous slices of the leading axis of ``x``
    (which the mesh size must divide), each on its shard's device."""
    r = x.shape[0]
    if r % mesh.size:
        raise ValueError(f"{r} rows do not divide into {mesh.size} shards")
    per = r // mesh.size
    first = mesh.rank * len(mesh.devices)
    return [x[(first + i) * per:(first + i + 1) * per].to(d)
            for i, d in enumerate(mesh.devices)]


def replicate(mesh: Mesh, obj) -> tuple:
    """``obj`` (a tensor, a ``SceneData``, ``ClusterSet`` or ``DeviceBVH``,
    or None) per shard: one copy per distinct device, shared by the shards
    on it (the object itself on the device that holds it).  The copies are
    kept (``models.programs.replica``: one per object and device, until an
    in-place edit of the object, ``programs.drop`` or ``programs.clear``),
    so that the programs of a device, keyed on its copy, replay."""
    return tuple(None if obj is None else programs.replica(obj, d)
                 for d in mesh.devices)
