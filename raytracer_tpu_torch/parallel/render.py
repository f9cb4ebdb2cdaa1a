"""Sharded rendering (port of ``raytracer_tpu/parallel/render.py``): the
ray axis split over the mesh, the scene and its accelerator replicated.

Rays never communicate, so each shard traces its contiguous slice of the
wavefront on its own device (``models.whitted.trace``, which cuts a
slice above the ray chunk into chunk-sized wavefronts) and the image is
assembled by one gather across processes.  On a CUDA device the shards
replay their device's captured wavefront programs, on every engine (the
counterpart of the JAX package's ``jax.jit(shard_map(...))``): shards of
one size on one device share one program, whose key is the shape, and
each device's scene is a kept copy (``parallel.mesh.replicate``).
"""

from __future__ import annotations

import numpy as np
import torch

from raytracer_tpu_torch.models.scene import Camera, SceneData, SceneMeta
from raytracer_tpu_torch.parallel.distributed import assemble_image
from raytracer_tpu_torch.parallel.mesh import Mesh, replicate, shard_rays


def render_rays_sharded(data: SceneData, meta: SceneMeta, origin, dirs,
                        mesh: Mesh, accel=None, engine: str = "brute", *,
                        chunk: int = 1 << 22, bfc: bool = False,
                        relaxed: bool = False) -> torch.Tensor:
    """(R / world, 3) radiance of this process's shards of the wavefront
    (``origin`` (3,) shared or (R, 3); ``dirs`` (R, 3), R a multiple of
    the mesh size, in tile order for the cluster engine), concatenated on
    the mesh's first device.  ``engine`` as ``models.whitted.render_rays``
    takes it (``auto`` resolved)."""
    from raytracer_tpu_torch.models.whitted import resolve_engine, trace

    engine = resolve_engine(engine, accel, meta)
    per_ray = origin.dim() == 2
    origins = shard_rays(mesh, origin) if per_ray else [
        origin.to(d) for d in mesh.devices]
    colors = [
        trace(d_data, meta, org, dd, d_accel, chunk, bfc=bfc,
              relaxed=relaxed, engine=engine).to(mesh.devices[0])
        for d_data, d_accel, org, dd in zip(
            replicate(mesh, data), replicate(mesh, accel), origins,
            shard_rays(mesh, dirs))]
    return torch.cat(colors)


def render_camera_sharded(data: SceneData, meta: SceneMeta, cam: Camera,
                          mesh: Mesh, accel=None, engine: str = "brute",
                          chunk: int = 1 << 22) -> np.ndarray:
    """Host (H, W, 3) f32 radiance of ``cam`` over the mesh.  On the
    cluster engine the rays take the tile order BEFORE sharding, so that
    every shard holds whole 8x16 blocks; the ray count is padded to a
    multiple of the mesh size with copies of the last ray, and the
    gathered image is cropped and put back in row order."""
    from raytracer_tpu_torch.models.whitted import (
        _tile_order, resolve_engine,
    )
    from raytracer_tpu_torch.ops.camera import camera_vectors, eye_rays_from
    from raytracer_tpu_torch.ops.tiling import apply_tile_order, undo_tile_order

    engine = resolve_engine(engine, accel, meta)
    dev = mesh.devices[0]
    h, w = cam.height, cam.width
    vec = torch.from_numpy(camera_vectors(cam)).to(dev)
    origin, dirs = eye_rays_from(vec, w, h)
    blocks, perm, inv = _tile_order(h, w, dev, engine)
    dirs = apply_tile_order(dirs, h, w, blocks, perm)
    r = dirs.shape[0]
    pad = (-r) % mesh.size
    dirs = torch.cat([dirs, dirs[-1:].expand(pad, 3)]).contiguous()
    local = render_rays_sharded(data, meta, origin, dirs, mesh, accel,
                                engine, chunk=chunk)
    color = torch.from_numpy(assemble_image(local, mesh)[:r])
    color = undo_tile_order(color, h, w, blocks,
                            None if inv is None else inv.cpu())
    return color.reshape(h, w, 3).numpy()
