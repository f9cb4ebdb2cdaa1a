"""Differentiable inverse rendering: the training step (port of
``raytracer_tpu/parallel/train.py``), on one device or over a mesh.

Given a target image, recover scene parameters (vertex positions, sphere
radii, material reflectances, light positions and intensities) by Adam
on an L2 image loss through ``render_rays(differentiable=True)``.  The
visibility engines run without gradient and the accelerator is built
once, from the initial scene: as ``vertices`` train, the clusters and
the BVH go stale, as in the JAX package.

``torch.optim.Adam`` at its defaults (betas 0.9/0.999, eps 1e-8) makes
optax ``adam``'s update ``lr * m_hat / (sqrt(v_hat) + eps)``; the two
differ only in rounding.

Over a mesh (``parallel.mesh``) the rays and the target are split into
the shards; the master parameters stay on the mesh's first device, and
each shard renders through a differentiable copy on its own device, so
its gradient flows back to them.  The loss and the gradients are the
means over the shards: over this process's shards by autograd, then over
the processes by an all-reduce (the JAX step's two ``pmean``s), before
one ``Adam.step()`` on every rank from the same numbers, so every rank
keeps the same parameters bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from raytracer_tpu_torch.backend import resolve_device
from raytracer_tpu_torch.models.scene import SceneData, SceneMeta
from raytracer_tpu_torch.models.whitted import render_rays
from raytracer_tpu_torch.parallel.distributed import all_mean
from raytracer_tpu_torch.parallel.mesh import replicate, shard_rays

# SceneData fields that train; geometry gradients flow through
# ``vertices`` (triangle corners and sphere centers)
PARAM_FIELDS = (
    "vertices",
    "sphere_rad",
    "mat_ambient",
    "mat_diffuse",
    "mat_specular",
    "mat_mirror",
    "light_pos",
    "light_int",
)


class TrainState(NamedTuple):
    params: dict               # field -> leaf tensor (requires grad)
    opt: torch.optim.Adam      # over params' tensors


def extract_params(data: SceneData, fields=PARAM_FIELDS) -> dict:
    return {f: getattr(data, f) for f in fields}


def apply_params(data: SceneData, params: dict) -> SceneData:
    return dataclasses.replace(data, **params)


def image_loss(params, data, meta, origin, dirs, target, accel, engine,
               ldr: bool = False):
    """Mean squared error between the rendered radiance of rays (origin,
    dirs) and ``target`` (R, 3).  ``ldr``: the target is an 8-bit image,
    so the radiance is clipped to [0, 255] first (clipped channels get no
    gradient, like a saturated camera)."""
    color = render_rays(apply_params(data, params), meta, origin, dirs, accel,
                        engine=engine, differentiable=True)
    if ldr:
        color = torch.clamp(color, 0.0, 255.0)
    return torch.mean((color - target) ** 2)


def make_train_step(meta: SceneMeta, lr: float = 3e-2, engine: str = "brute",
                    ldr: bool = False, device="cuda", mesh=None):
    """The step ``(state, data, origin, dirs, target, accel=None) ->
    (state, loss)``: the loss at the current params, then one Adam update
    at ``lr`` of ``state``'s params (in place).  Runs on ``device`` (CUDA
    by default; raises without a GPU), which must hold the data, the rays
    and the state.  ``mesh``: ``dirs`` and ``target`` (and a per-ray
    ``origin``) are the whole batch, whose rows the mesh size divides;
    each shard traces its slice (``shard_rays``) and the loss and the
    gradients are the shards' means; ``device`` is the mesh's first."""
    dev = resolve_device(device)
    if mesh is not None and mesh.devices[0] != dev:
        raise ValueError(f"mesh on {mesh.devices[0]}, training on {dev}")

    def step(state: TrainState, data, origin, dirs, target, accel=None):
        for name, x in (("scene", data.vertices), ("rays", dirs),
                        ("target", target),
                        *((f, p) for f, p in state.params.items())):
            if x.device != dev:
                raise ValueError(f"{name} on {x.device}, training on {dev}")
        for group in state.opt.param_groups:
            group["lr"] = lr
        state.opt.zero_grad(set_to_none=True)
        if mesh is None:
            loss = image_loss(state.params, data, meta, origin, dirs, target,
                              accel, engine, ldr)
            loss.backward()
            state.opt.step()
            return state, loss.detach()
        n = len(mesh.devices)
        origins = (shard_rays(mesh, origin) if origin.dim() == 2
                   else [origin.to(d) for d in mesh.devices])
        loss = torch.zeros((), device=dev)
        for d, d_data, d_accel, org, dd, tt in zip(
                mesh.devices, replicate(mesh, data), replicate(mesh, accel),
                origins, shard_rays(mesh, dirs), shard_rays(mesh, target)):
            params = {f: p.to(d) for f, p in state.params.items()}
            shard = image_loss(params, d_data, meta, org, dd, tt, d_accel,
                               engine, ldr) / n
            shard.backward()
            loss = loss + shard.detach().to(dev)
        for p in state.params.values():
            if p.grad is not None:
                p.grad = all_mean(p.grad, mesh)
        state.opt.step()
        return state, all_mean(loss, mesh)

    return step


def init_state(data: SceneData, fields=PARAM_FIELDS) -> TrainState:
    """A fresh state training ``fields`` of ``data`` (copies, on its
    device); the other fields stay as they are.  The learning rate is
    ``make_train_step``'s."""
    params = {f: getattr(data, f).detach().clone().requires_grad_(True)
              for f in fields}
    return TrainState(params, torch.optim.Adam(list(params.values())))
