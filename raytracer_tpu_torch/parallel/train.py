"""Differentiable inverse rendering: the training step (port of
``raytracer_tpu/parallel/train.py`` on one device).

Given a target image, recover scene parameters (vertex positions, sphere
radii, material reflectances, light positions and intensities) by Adam
on an L2 image loss through ``render_rays(differentiable=True)``.  The
visibility engines run without gradient and the accelerator is built
once, from the initial scene: as ``vertices`` train, the clusters and
the BVH go stale, as in the JAX package.

``torch.optim.Adam`` at its defaults (betas 0.9/0.999, eps 1e-8) makes
optax ``adam``'s update ``lr * m_hat / (sqrt(v_hat) + eps)``; the two
differ only in rounding.  The JAX package's mesh and ``pmean`` are not
ported (one device).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from raytracer_tpu_torch.backend import resolve_device
from raytracer_tpu_torch.models.scene import SceneData, SceneMeta
from raytracer_tpu_torch.models.whitted import render_rays

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
                    ldr: bool = False, device="cuda"):
    """The step ``(state, data, origin, dirs, target, accel=None) ->
    (state, loss)``: the loss at the current params, then one Adam update
    at ``lr`` of ``state``'s params (in place).  Runs on ``device`` (CUDA
    by default; raises without a GPU), which must hold the data, the rays
    and the state."""
    dev = resolve_device(device)

    def step(state: TrainState, data, origin, dirs, target, accel=None):
        for name, x in (("scene", data.vertices), ("rays", dirs),
                        ("target", target),
                        *((f, p) for f, p in state.params.items())):
            if x.device != dev:
                raise ValueError(f"{name} on {x.device}, training on {dev}")
        for group in state.opt.param_groups:
            group["lr"] = lr
        state.opt.zero_grad(set_to_none=True)
        loss = image_loss(state.params, data, meta, origin, dirs, target,
                          accel, engine, ldr)
        loss.backward()
        state.opt.step()
        return state, loss.detach()

    return step


def init_state(data: SceneData, fields=PARAM_FIELDS) -> TrainState:
    """A fresh state training ``fields`` of ``data`` (copies, on its
    device); the other fields stay as they are.  The learning rate is
    ``make_train_step``'s."""
    params = {f: getattr(data, f).detach().clone().requires_grad_(True)
              for f in fields}
    return TrainState(params, torch.optim.Adam(list(params.values())))
