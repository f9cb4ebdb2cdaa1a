"""Scaling: rays/s against mesh size (port of
``raytracer_tpu/parallel/scaling.py``).

For each mesh size n the same wavefront is traced with its ray axis
split over n shards (``render_rays_sharded``) and the sustained rays/s
recorded.  Rays never communicate, so on n cards (one process each, or
the cards of one process) throughput should grow about n-fold.

A mesh of logical shards on one device (n shards on one card, or on the
CPU) checks the split and its dispatch, not the scaling: the shards run
one after another on the same device, and its efficiency is not a
scaling result.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

from raytracer_tpu_torch.backend import resolve_device
from raytracer_tpu_torch.models.scene import SceneData, SceneMeta
from raytracer_tpu_torch.parallel.mesh import local_cards, make_mesh
from raytracer_tpu_torch.parallel.render import render_rays_sharded


@dataclasses.dataclass
class ScalePoint:
    n_devices: int
    rays_per_s: float
    seconds_per_frame: float
    efficiency: float  # rays_per_s / (n * rays_per_s[n=1])


def measure_scaling(data: SceneData, meta: SceneMeta, origin, dirs,
                    accel=None, engine: str = "brute",
                    sizes: Optional[Sequence[int]] = None, frames: int = 3,
                    device="cuda") -> List[ScalePoint]:
    """The scaling curve over mesh ``sizes`` (default 1, 2, 4, 8 up to the
    cards; on the CPU 1, 2): mesh n takes the first n cards, wrapping round
    onto them as logical shards past the last card (on the CPU, n logical
    shards).  Each size traces ``dirs`` (trimmed to a multiple of n) once
    to warm up, then ``frames`` times back to back, timed from the host
    between two ``torch.cuda.synchronize()``s.  ``data``, ``accel`` and
    the rays are on ``device``, the meshes' first device."""
    import torch

    dev = resolve_device(device)
    pool = [dev] if dev.type == "cpu" else local_cards()
    if pool[0] != dev:
        raise ValueError(f"the meshes start on {pool[0]}, data on {dev}")
    if sizes is None:
        sizes = ([1, 2] if dev.type == "cpu"
                 else [n for n in (1, 2, 4, 8) if n <= len(pool)])

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    r = dirs.shape[0]
    points: List[ScalePoint] = []
    base = None
    for n in sizes:
        mesh = make_mesh([pool[i % len(pool)] for i in range(n)])
        rr = r - r % mesh.size
        d = dirs[:rr]
        org = origin[:rr] if origin.dim() == 2 else origin
        render_rays_sharded(data, meta, org, d, mesh, accel, engine)
        sync()
        t0 = time.perf_counter()
        for _ in range(frames):
            render_rays_sharded(data, meta, org, d, mesh, accel, engine)
        sync()
        dt = (time.perf_counter() - t0) / frames
        rays_per_s = rr / dt
        if base is None:
            base = rays_per_s
        points.append(ScalePoint(n_devices=mesh.size, rays_per_s=rays_per_s,
                                 seconds_per_frame=dt,
                                 efficiency=rays_per_s / (mesh.size * base)))
    return points
