"""Training traffic: full-batch inverse rendering, the route of the port's
train CLI with ``--batch 0``.

Set-up: the true scene from the seed; its linear radiance over every
raster eye ray of the mix's camera, which the benchmark makes with the
plain reference (its visibility kept on the host for the check; this
reference work is left out of ``setup_s``, and the peak of device memory
counts from after it); the start scene (``start_scale`` of the true
diffuse reflectances and light intensities) written as XML and loaded
through ``load_scene``; the accelerator; the state from ``init_state`` of
the mix's ``fields`` and the step from ``make_train_step`` (the mix's
engine and ``lr``), driven through its first ``checked_steps`` steps and
``warmup_steps`` more.  Window: steps of that same object until
``--seconds`` have passed, then a sync; ``train_step_ms`` is the window's
ms over its steps.  Traced: ``trace_steps`` steps from ``trace_after`` of
the window on, under the profiler, in ``bench.step`` spans, with a sync
before the first and inside the last.  After the window the state is
taken (parameters, Adam's moments and step count) and ``checked_steps``
more steps of the same object, replayed as the window's were, follow.

Check: the program is freed, and the plain reference follows both runs
of checked steps (``reference/train.py``): the first from the same start
and a fresh Adam, the last from the state taken after the window, which
is the program's own.  For each, ``loss_rel`` is the worst step's
relative loss gap; ``grad_rel`` the worst step's and leaf's gap between
the program's and the reference's norms of the step's gradient (the
program's worked out from Adam's first moment before and after the
step: the first step of set-up runs eagerly, the others replay the
captured program); ``change_rel`` the worst leaf's gap of norms of the
parameters' change over the run.  A gap is measured against the larger
of the leaf's norm and the median leaf's in the reference's run from the
start: after the window the gradients are all but nought, the diffuse
reflectances at their optimum.  Leaves whose first reference gradient is
under a thousandth of the median leaf's are left out of ``change_rel``
(Adam moves them by round-off).  The last run's numbers are named
``end_`` and the same.
"""

from __future__ import annotations

import copy
import os
import time
import types
from typing import NamedTuple

import numpy as np

from benchmark import harness, sceneio
from benchmark.reference import train as ref_train

# the program's leaf names and the reference's
LEAVES = {"mat_diffuse": "diffuse", "light_int": "light_int"}


class Steps(NamedTuple):
    """A run of checked steps: where it started (``ref_train.AdamState``,
    on the host, keyed by the reference's names), each step's loss and
    gradients, and the parameters' change over the run."""
    start: ref_train.AdamState
    losses: list
    grads: list
    change: dict


def start_scene(parsed: dict, scale: dict) -> dict:
    out = copy.deepcopy(parsed)
    for m in out["materials"]:
        m["diffuse"] = [x * scale["diffuse"] for x in m["diffuse"]]
    out["point_lights"] = [(p, [x * scale["light_int"] for x in q])
                           for p, q in out["point_lights"]]
    return out


def reference_rays(cam: dict, tile, device):
    """The camera's raster eye rays from the plain reference, in tiles of
    ``tile`` pixels, and that order's raster indices."""
    from benchmark.reference import whitted as ref

    w, h = cam["width"], cam["height"]
    order = ref.tile_order(h, w, *tile).to(device)
    o, d = ref.eye_rays(cam, w, h, order // w, order % w, device)
    return o, d, order


def worst_leaf(prog: dict, ref: dict, counted=None, scale=None) -> float:
    """max over leaves of |norm(prog) - norm(ref)| / max(norm(scale),
    median leaf norm of scale), ``scale`` ``ref`` by default."""
    norms = {k: float(np.linalg.norm(v)) for k, v in ref.items()}
    sizes = {k: float(np.linalg.norm(v)) for k, v in (scale or ref).items()}
    med = float(np.median(list(sizes.values())))
    keys = counted if counted is not None else list(ref)
    return max(abs(float(np.linalg.norm(prog[k])) - norms[k])
               / max(sizes[k], med, 1e-30) for k in keys)


def adam_state(state) -> ref_train.AdamState:
    """The program's parameters, Adam's moments and step count, on the
    host (zeros and 0 before its first step)."""
    import torch

    params, m, v, t = {}, {}, {}, 0
    for k, p in state.params.items():
        s = state.opt.state.get(p, {})
        name = LEAVES[k]
        params[name] = p.detach().cpu().clone()
        zero = torch.zeros_like(params[name])
        m[name] = s["exp_avg"].detach().cpu().clone() if s else zero
        v[name] = s["exp_avg_sq"].detach().cpu().clone() if s else zero
        t = int(float(s["step"])) if s else 0
    return ref_train.AdamState(params, m, v, t)


def checked(s, n: int) -> Steps:
    """``n`` steps of the program ``s.step`` from its state now."""
    start = now = adam_state(s.state)
    losses, grads = [], []
    for _ in range(n):
        s.state, loss = s.step(s.state, *s.args)
        losses.append(float(loss))
        # the gradient as Adam took it: m_t = b1 m_(t-1) + (1 - b1) g_t
        before, now = now, adam_state(s.state)
        grads.append({k: ((now.m[k] - ref_train.BETA1 * before.m[k])
                          / (1 - ref_train.BETA1)).numpy() for k in now.m})
    return Steps(start, losses, grads,
                 {k: (now.params[k] - start.params[k]).numpy()
                  for k in now.params})


def setup(ctx):
    """The target, the program and its first checked steps: a namespace
    the window, the check and the calibration share."""
    import torch

    from benchmark.reference import whitted as ref
    from raytracer_tpu_torch.models.scene import load_scene
    from raytracer_tpu_torch.ops.camera import camera_vectors, eye_rays_from
    from raytracer_tpu_torch.parallel.train import init_state, make_train_step
    from raytracer_tpu_torch.render import engine_accel

    tr, dev = ctx.traffic, ctx.device
    s = types.SimpleNamespace()
    s.parsed = sceneio.generate(ctx.bench, ctx.config, ctx.seed)
    cam = s.parsed["cameras"][tr["camera"]]
    s.group = tr["ref_tile"][0] * tr["ref_tile"][1]

    # the target: the true scene's radiance, made by the plain reference
    t_ref = time.perf_counter()
    scene = ref.Scene(s.parsed, dev)
    s.o_ref, s.d_ref, order = reference_rays(cam, tr["ref_tile"], dev)
    with torch.no_grad():
        color, vis = ref.render(scene, s.o_ref, s.d_ref, group=s.group,
                                record=True)
    target = torch.empty_like(color)
    target[order] = color
    s.vis = ref.Visibility(*([x.cpu() for x in part] for part in vis))
    s.target_tiles = color.cpu()              # the reference's ray order
    del scene, color, vis
    harness.free_program()
    ctx.leave_out(time.perf_counter() - t_ref)
    if dev != "cpu":
        torch.cuda.reset_peak_memory_stats()

    s.start = start_scene(s.parsed, tr["start_scale"])
    xml = os.path.join(ctx.work_dir, "start.xml")
    sceneio.write_xml(s.start, xml)
    data, meta = load_scene(xml, device=dev)
    accel = engine_accel(tr["engine"], None, data, meta, dev)
    pcam = meta.cameras[tr["camera"]]
    vec = torch.from_numpy(camera_vectors(pcam)).to(dev)
    origin, dirs = eye_rays_from(vec, pcam.width, pcam.height)
    s.state = init_state(data, fields=tuple(tr["fields"]))
    s.step = make_train_step(meta, lr=tr["lr"], engine=tr["engine"],
                             device=dev)
    s.args = (data, origin, dirs, target, accel)
    s.first = checked(s, tr["checked_steps"])
    for _ in range(tr["warmup_steps"]):
        s.state, _ = s.step(s.state, *s.args)
    return s


def window(ctx, s) -> None:
    """Steps until ``ctx.seconds`` have passed (a traced run until its
    stretch is whole), then the state's last checked steps."""
    tr = ctx.traffic
    steps, prof, first = 0, None, 0
    t0 = time.perf_counter()
    while (time.perf_counter() - t0 < ctx.seconds
           or (prof is not None and ctx.trace is None)):
        if (ctx.trace_on and prof is None
                and time.perf_counter() - t0 >= tr["trace_after"] * ctx.seconds):
            ctx.sync()
            prof, first = harness.Profiled(
                harness.port_kernel_names(ctx.bench.root)).__enter__(), steps
        with harness.span("step"):
            s.state, _ = s.step(s.state, *s.args)
            steps += 1
            last = prof is not None and ctx.trace is None and (
                steps - first >= tr["trace_steps"])
            if last:
                ctx.sync()
        if last:
            prof.__exit__(None, None, None)
            ctx.trace = prof.trace({})
    ctx.sync()
    elapsed = time.perf_counter() - t0
    ctx.attempted = steps
    ctx.e2e["train_step_ms"] = elapsed / steps * 1e3
    ctx.read_peak()
    if prof is not None and ctx.trace is None:
        prof.__exit__(None, None, None)
        ctx.trace = prof.trace({})
    s.end = checked(s, tr["checked_steps"])
    del s.state, s.step, s.args
    harness.free_program()


def reference(ctx, s, dtype=None, rays=None):
    """The plain reference's ``Steps`` of both checked runs: from the
    start scene, and from the program's state after the window.  With
    ``dtype`` (the control) it traces and trains in that precision; with
    ``rays`` (a slice: the half-batch fault) it takes those rays only."""
    import torch

    from benchmark.reference import whitted as ref

    dev, tr = ctx.device, ctx.traffic
    dtype = dtype or torch.float32
    rays = rays or slice(None)
    scene = ref.Scene(s.start, dev, dtype)
    o, d = s.o_ref, s.d_ref[rays]
    target = s.target_tiles[rays].to(dev)
    if dtype == torch.float32 and rays == slice(None):
        vis = ref.Visibility(*([x.to(dev) for x in part] for part in s.vis))
    else:
        with torch.no_grad():
            _, vis = ref.render(ref.Scene(s.parsed, dev, dtype), o, d,
                                group=s.group, record=True)
    own = ref_train.AdamState({k: getattr(scene, k).float().cpu()
                               for k in ref_train.LEAVES}, None, None, 0)
    out = []
    # the first run from the reference's own start, the last from the
    # program's state after the window
    for start in (None, s.end.start):
        losses, grads, params = ref_train.train(
            scene, o, d, target, vis, tr["lr"], tr["checked_steps"], s.group,
            start)
        base = (start or own).params
        out.append(Steps(start or own, losses,
                         [{k: g.float().cpu().numpy() for k, g in step.items()}
                          for step in grads],
                         {k: (params[k].float().cpu() - base[k]).numpy()
                          for k in params}))
    return out


def numbers(prog: Steps, ref: Steps, scale: Steps = None) -> dict:
    """``loss_rel``, ``grad_rel`` (the worst step) and ``change_rel`` of
    ``prog`` against ``ref``; the leaves' sizes (the denominators, and
    the rule that leaves a leaf out of the change) are ``scale``'s, the
    reference's run from the start, where given: at the end of a window
    the gradients are all but nought."""
    scale = scale or ref
    norms = {k: float(np.linalg.norm(g)) for k, g in scale.grads[0].items()}
    med = float(np.median(list(norms.values())))
    moved = [k for k, n in norms.items() if n >= 1e-3 * med]
    return {"loss_rel": max(abs(a - b) / abs(b)
                            for a, b in zip(prog.losses, ref.losses)),
            "grad_rel": max(worst_leaf(p, r, scale=g) for p, r, g in
                            zip(prog.grads, ref.grads, scale.grads)),
            "change_rel": worst_leaf(prog.change, ref.change, moved,
                                     scale.change)}


def run(ctx) -> None:
    s = setup(ctx)
    if ctx.trace_on:
        harness.warm_profiler(ctx.device)
    ctx.setup_done()
    window(ctx, s)
    t_ref = time.perf_counter()
    first, end = reference(ctx, s)
    for prefix, prog, ref in (("", s.first, first), ("end_", s.end, end)):
        for name, value in numbers(prog, ref, first).items():
            ctx.check(prefix + name, value)
    harness.log(f"reference check: {time.perf_counter() - t_ref:.3f} s")
