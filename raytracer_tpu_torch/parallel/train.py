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
the processes by an all-reduce in place (the JAX step's two ``pmean``s),
before one ``Adam.step()`` on every rank from the same numbers, so every
rank keeps the same parameters bit for bit.
"""

from __future__ import annotations

import dataclasses
import gc
from collections import OrderedDict
from typing import NamedTuple

import torch

from raytracer_tpu_torch import tracing
from raytracer_tpu_torch.backend import resolve_device
from raytracer_tpu_torch.models import programs
from raytracer_tpu_torch.models.scene import SceneData, SceneMeta
from raytracer_tpu_torch.models.whitted import _Wavefront, render_rays
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
               ldr: bool = False, visibility=None):
    """Mean squared error between the rendered radiance of rays (origin,
    dirs) and ``target`` (R, 3).  ``ldr``: the target is an 8-bit image,
    so the radiance is clipped to [0, 255] first (clipped channels get no
    gradient, like a saturated camera).  ``visibility``: the BVH engine's
    recorded visibility of these rays (``render_rays``)."""
    color = render_rays(apply_params(data, params), meta, origin, dirs, accel,
                        engine=engine, differentiable=True,
                        visibility=visibility)
    if ldr:
        color = torch.clamp(color, 0.0, 255.0)
    return torch.mean((color - target) ** 2)


def _loss_and_grads(state: TrainState, data, meta, origin, dirs, target,
                    accel, engine: str, ldr: bool, mesh, dev, visibility=None):
    """This process's loss at ``state``'s params, its gradients accumulated
    into their ``.grad`` (zeroed in place first, so that the buffers stay
    put): on one device, or as the means over this process's shards.  The
    mean over the processes follows (``_all_mean``).  ``visibility``: the
    BVH engine's recorded visibility of each of this process's shards (one
    without a mesh), else traced by ``render_rays``."""
    state.opt.zero_grad(set_to_none=False)
    if mesh is None:
        loss = image_loss(state.params, data, meta, origin, dirs, target,
                          accel, engine, ldr,
                          visibility and visibility[0])
        loss.backward()
        return loss.detach()
    n = len(mesh.devices)
    origins = (shard_rays(mesh, origin) if origin.dim() == 2
               else [origin.to(d) for d in mesh.devices])
    loss = torch.zeros((), device=dev)
    for i, (d, d_data, d_accel, org, dd, tt) in enumerate(zip(
            mesh.devices, replicate(mesh, data), replicate(mesh, accel),
            origins, shard_rays(mesh, dirs), shard_rays(mesh, target))):
        params = {f: p.to(d) for f, p in state.params.items()}
        shard = image_loss(params, d_data, meta, org, dd, tt, d_accel,
                           engine, ldr, visibility and visibility[i]) / n
        shard.backward()
        loss = loss + shard.detach().to(dev)
    return loss


def _all_mean(state: TrainState, loss, mesh) -> None:
    """The loss and every gradient made their means over the processes, in
    place (``distributed.all_mean``, the JAX step's two ``pmean``s): a
    host step, between a captured step's graphs; nothing with one
    process."""
    if mesh is None or mesh.world == 1:
        return
    all_mean(loss, mesh)
    for p in state.params.values():
        if p.grad is not None:
            all_mean(p.grad, mesh)


class _TrainProgram:
    """One training step as a captured program (``programs.Step``), the
    counterpart of the JAX package's ``jax.jit(shard_map(local_step))``:
    with one process forward, backward and the Adam update in one graph;
    over several processes two, "loss and gradients" and "adam", with the
    all-reduce of the loss and the gradients (``_all_mean``, in place)
    between them as a host step (gloo reduces host copies; an NCCL
    collective stays outside the graphs too).  Its static inputs
    ``origin``, ``dirs`` and ``target`` are copied in before each run; the
    body writes the loss into the static ``loss``.  The first run is eager
    (Adam's lazy state, every kernel instance warmed), the capture follows
    and later runs replay: the gradients stay in the ``.grad`` buffers the
    first run made, the parameters and Adam's moments and step count
    (``capturable``, on the card) are updated in place, and ``lr`` is the
    one written before the first run (a graph bakes it in).  The graphs
    have a memory pool of their own, freed with the program.

    On the BVH engine, whose walks read the host between their blocks, a
    visibility pass comes first: per shard a recording ``_Wavefront``
    (steps in the same pool, no gradient) traces the bounces at the
    current params into its static ``ids`` and ``occ``, and the graphs'
    forward refines and shades from them (``render_rays``'s
    ``visibility``).  The brute engine's forward has no host read: it is
    in the one graph, as the cluster engine's."""

    def __init__(self, state: TrainState, data, meta, origin, dirs, target,
                 accel, local, mesh, versions, graph_type, engine: str):
        self.progs = programs.Programs(
            (tuple(state.params.values()), state.opt, data, meta, accel),
            versions, graph_type, dirs.device)
        self.state, self.data, self.accel = state, data, accel
        self.local, self.mesh = local, mesh
        self.origin = torch.zeros_like(origin)
        self.dirs = torch.zeros_like(dirs)
        self.target = torch.zeros_like(target)
        self.loss = torch.zeros((), device=dirs.device)
        self.grads = None
        self.visibility = []
        if engine == "bvh":
            # the params' own storage: Adam's in-place updates show here
            vdata = apply_params(data, {f: p.detach() for f, p in
                                        state.params.items()})
            rays = [(self.origin, self.dirs)]
            if mesh is not None:
                n = len(mesh.devices)
                rays = list(zip(shard_rays(mesh, self.origin)
                                if origin.dim() == 2 else [self.origin] * n,
                                shard_rays(mesh, self.dirs)))
            for o, d in rays:
                self.visibility.append((_Wavefront(
                    vdata, meta, accel, d.shape[0], o.dim() == 1, False,
                    False, "auto", d.device, self.progs.step, "bvh",
                    record=True), o, d))
        if mesh is None or mesh.world == 1:
            self.steps = (self.progs.step("train step", self._body),)
        else:
            # the all-reduce runs on the host, between the two graphs
            self.steps = (self.progs.step("loss and gradients", self._grads),
                          self._all_mean,
                          self.progs.step("adam", state.opt.step))

    def _all_mean(self) -> None:
        _all_mean(self.state, self.loss, self.mesh)

    def _grads(self) -> None:
        self.loss.copy_(self.local(
            self.state, self.data, self.origin, self.dirs, self.target,
            self.accel, [(wf.ids, wf.occ) for wf, _, _ in self.visibility]
            or None))

    def _body(self) -> None:
        self._grads()
        self.state.opt.step()

    def __call__(self, origin, dirs, target) -> torch.Tensor:
        params = self.state.params.values()
        with torch.no_grad():
            self.origin.copy_(origin)
            self.dirs.copy_(dirs)
            self.target.copy_(target)
        if self.grads is not None:
            # the graph writes the gradient buffers of its first run: kept
            # here, and handed back to a parameter whose .grad was dropped
            for p, g in zip(params, self.grads):
                if p.grad is not g:
                    p.grad = g
        for wf, o, d in self.visibility:
            wf.load(o, d)
            wf.run()
        for step in self.steps:
            step()
        if self.grads is None:
            self.grads = tuple(p.grad for p in params)
        return self.loss.clone()


# training programs kept per make_train_step (least recently used first
# out): a new state (a resumed checkpoint) or shape takes a new one
MAX_TRAIN_PROGRAMS = 2


def make_train_step(meta: SceneMeta, lr: float = 3e-2, engine: str = "brute",
                    ldr: bool = False, device="cuda", mesh=None):
    """The step ``(state, data, origin, dirs, target, accel=None) ->
    (state, loss)``: the loss at the current params, then one Adam update
    at ``lr`` of ``state``'s params (in place).  Runs on ``device`` (CUDA
    by default; raises without a GPU), which must hold the data, the rays
    and the state.  ``mesh``: ``dirs`` and ``target`` (and a per-ray
    ``origin``) are the whole batch, whose rows the mesh size divides;
    each shard traces its slice (``shard_rays``) and the loss and the
    gradients are the shards' means; ``device`` is the mesh's first.

    On a CUDA device the step replays a captured program on every engine
    (``_TrainProgram``, on the BVH engine after its visibility pass;
    ``state`` needs ``Adam(capturable=True)``, which ``init_state`` makes
    there) without a mesh and on a mesh whose shards of this process all
    sit on ``device`` (over several processes too, torchrun's one card a
    process: two graphs around the all-reduce), outside ``eager()`` and
    ``debug_nans()``: one program per state, scene and shape, at most
    ``MAX_TRAIN_PROGRAMS``.  The eager step remains for a mesh of several
    cards in one process (its autograd crosses devices), and on the CPU."""
    dev = resolve_device(device)
    if mesh is not None and mesh.devices[0] != dev:
        raise ValueError(f"mesh on {mesh.devices[0]}, training on {dev}")
    one_device = mesh is None or all(d == dev for d in mesh.devices)
    kept: "OrderedDict[tuple, _TrainProgram]" = OrderedDict()

    def local(state, data, origin, dirs, target, accel, visibility=None):
        return _loss_and_grads(state, data, meta, origin, dirs, target,
                               accel, engine, ldr, mesh, dev, visibility)

    def run(state, data, origin, dirs, target, accel):
        loss = local(state, data, origin, dirs, target, accel)
        _all_mean(state, loss, mesh)
        state.opt.step()
        return loss

    def program(state, data, origin, dirs, target, accel) -> _TrainProgram:
        if dev.type == "cuda" and not all(
                g.get("capturable") for g in state.opt.param_groups):
            raise ValueError("a captured training step needs "
                             "torch.optim.Adam(capturable=True) (init_state "
                             "makes it on a CUDA device)")
        key = (tuple(map(id, state.params.values())), id(state.opt),
               id(data), id(meta), id(accel), tuple(origin.shape),
               tuple(dirs.shape), tuple(target.shape))
        versions = programs._versions(data, accel, skip=state.params)
        prog = kept.get(key)
        if prog is None or prog.progs.versions != versions:
            stale = prog is not None
            for group in state.opt.param_groups:
                group["lr"] = lr
            with tracing.setup_span("program.make", "train"):
                prog = kept[key] = _TrainProgram(
                    state, data, meta, origin, dirs, target, accel, local,
                    mesh, versions, programs.graph_class(dev), engine)
            if len(kept) > MAX_TRAIN_PROGRAMS:
                kept.popitem(last=False)
                stale = True
            if stale:
                gc.collect()        # a program's step calls back into it
        kept.move_to_end(key)
        return prog

    def step(state: TrainState, data, origin, dirs, target, accel=None):
        for name, x in (("scene", data.vertices), ("rays", dirs),
                        ("target", target),
                        *((f, p) for f, p in state.params.items())):
            if x.device != dev:
                raise ValueError(f"{name} on {x.device}, training on {dev}")
        if one_device and programs.enabled(dev):
            prog = program(state, data, origin, dirs, target, accel)
            return state, prog(origin, dirs, target)
        for group in state.opt.param_groups:
            group["lr"] = lr
        return state, run(state, data, origin, dirs, target, accel)

    step.programs = kept          # the kept programs, for measurement
    return step


def init_state(data: SceneData, fields=PARAM_FIELDS) -> TrainState:
    """A fresh state training ``fields`` of ``data`` (copies, on its
    device); the other fields stay as they are.  The learning rate is
    ``make_train_step``'s.  On a CUDA device Adam is ``capturable`` (its
    step count on the card), as a captured step needs."""
    params = {f: getattr(data, f).detach().clone().requires_grad_(True)
              for f in fields}
    return TrainState(params, _adam(list(params.values())))


def _adam(params: list) -> torch.optim.Adam:
    """``torch.optim.Adam`` over ``params``: ``capturable`` on a CUDA
    device, plain elsewhere (capturable Adam refuses CPU tensors)."""
    return torch.optim.Adam(params, capturable=params[0].device.type == "cuda")
