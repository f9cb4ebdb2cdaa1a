"""The plain reference of an inverse-rendering step: the L2 image loss of
``whitted.render`` against a target, its gradients by autograd, and
Adam written out (betas 0.9 / 0.999, eps 1e-8, the bias-corrected
update ``lr * m_hat / (sqrt(v_hat) + eps)``)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from benchmark.reference import whitted

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8
LEAVES = ("diffuse", "light_int")


class AdamState(NamedTuple):
    """Where a run of steps starts: the parameters, Adam's first and second
    moments (dicts keyed by ``LEAVES``) and its step count."""
    params: dict
    m: dict
    v: dict
    t: int


def train(scene: whitted.Scene, origin, dirs, target, visibility, lr: float,
          steps: int, group: int, start: Optional[AdamState] = None):
    """``steps`` Adam steps on the scene's ``diffuse`` and ``light_int``
    over the rays (origin, dirs) with the recorded ``visibility``, from
    ``start`` (default: the scene's values and a fresh Adam): (losses,
    each step's gradients, parameters after the last step), the dicts
    keyed by ``LEAVES``."""
    dt = scene.dtype
    if start is None:
        start = AdamState({k: getattr(scene, k) for k in LEAVES},
                          {k: torch.zeros_like(getattr(scene, k))
                           for k in LEAVES},
                          {k: torch.zeros_like(getattr(scene, k))
                           for k in LEAVES}, 0)
    params = {k: start.params[k].to(scene.device, dt).clone()
              .requires_grad_(True) for k in LEAVES}
    m = {k: start.m[k].to(scene.device, dt).clone() for k in LEAVES}
    v = {k: start.v[k].to(scene.device, dt).clone() for k in LEAVES}
    target = target.to(dt)
    losses, grads_seen = [], []
    for t in range(start.t + 1, start.t + steps + 1):
        color = whitted.render(scene, origin, dirs, group=group,
                               params=params, visibility=visibility)
        loss = torch.mean((color - target) ** 2)
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        grads_seen.append({k: g.detach().clone()
                           for k, g in zip(params, grads)})
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                m[k].mul_(BETA1).add_(g, alpha=1 - BETA1)
                v[k].mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
                m_hat = m[k] / (1 - BETA1 ** t)
                v_hat = v[k] / (1 - BETA2 ** t)
                p.sub_(lr * m_hat / (torch.sqrt(v_hat) + EPS))
    return losses, grads_seen, {k: p.detach() for k, p in params.items()}
