"""Inverse-rendering CLI: ``python -m raytracer_tpu_torch.train scene.xml
--target img.ppm [--fields mat_diffuse,light_int] [--steps N]`` (port of
``raytracer_tpu/train.py``).

Given a scene whose parameters are wrong and a target image of the true
scene, recover the parameters by Adam on an L2 image loss through the
differentiable renderer (``parallel/train.py``).  Eye rays are in raster
order; ``--batch`` draws a fresh pixel subset every step with
``np.random.default_rng(--seed).choice(..., replace=False)``, the JAX
package's draws.  Targets: PPM/PNG (uint8: radiance in the scene's 0-255
scale, clipped to it in the loss) or EXR (linear float).
``--checkpoint`` is a train-state npz in the JAX package's layout, so a
run of either package resumes in the other.  Runs on the GPU unless
``--device cpu``.

``--mesh auto|N`` splits each step's rays over a device mesh (every card
of the process by default; ``parallel.mesh.mesh_from_arg``), after
bringing up ``torch.distributed`` from torchrun's environment: the loss
and gradients are the shards' means, so every rank keeps the same
parameters, and rank 0 alone writes the checkpoint and ``--out``.  As in
the JAX CLI, ``--batch`` is rounded down to a multiple of the mesh size
(at least one ray a shard), and a whole frame that the mesh does not
divide drops its last rays once.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from raytracer_tpu_torch.parallel.train import PARAM_FIELDS


def load_target(path: str) -> np.ndarray:
    """(H, W, 3) f32 target image from a ppm, png or exr file."""
    ext = path.rsplit(".", 1)[-1].lower()
    if ext == "ppm":
        from raytracer_tpu_torch.utils.ppm import read_ppm

        return read_ppm(path).astype(np.float32)
    if ext == "png":
        from raytracer_tpu_torch.utils.png import read_png

        return read_png(path).astype(np.float32)
    if ext == "exr":
        from raytracer_tpu_torch.utils.exr import read_exr

        return read_exr(path).astype(np.float32)
    raise SystemExit(f"unsupported target format: {path}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="recover scene parameters from a target image "
                    "(differentiable inverse rendering)")
    ap.add_argument("scene", help="scene XML with the INITIAL (wrong) "
                                  "parameters")
    ap.add_argument("--target", required=True,
                    help="target image (ppm/png uint8 or exr linear float) "
                         "at the training resolution")
    ap.add_argument("--fields", default="mat_diffuse",
                    help="comma-separated SceneData fields to optimize "
                         f"(subset of {','.join(PARAM_FIELDS)})")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=3e-2)
    ap.add_argument("--batch", type=int, default=0,
                    help="rays per step (0 = the whole frame each step; "
                         "otherwise a fresh random pixel subset per step)")
    ap.add_argument("--camera", type=int, default=0,
                    help="camera index in the scene XML")
    ap.add_argument("--downscale", type=int, default=1,
                    help="divide the camera resolution by this factor "
                         "(target must match the reduced resolution)")
    ap.add_argument("--engine", choices=["brute", "bvh", "cluster"],
                    default="cluster")
    ap.add_argument("--checkpoint", default=None,
                    help="train-state npz: resumed from if it exists, "
                         "saved to every --checkpoint-every steps")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--out", default=None,
                    help="write the final recovered render here (ppm)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default; the CUDA kernels) or cpu (the plain "
                         "PyTorch versions)")
    ap.add_argument("--mesh", default="auto", metavar="auto|N",
                    help="device mesh (auto = every card of the process; N "
                         "shards over all processes, on the CPU logical "
                         "ones; 1 = one device)")
    args = ap.parse_args(argv)

    from raytracer_tpu_torch.backend import resolve_device
    from raytracer_tpu_torch.models.scene import load_scene
    from raytracer_tpu_torch.ops.camera import camera_vectors, eye_rays_from
    from raytracer_tpu_torch.parallel.distributed import initialize
    from raytracer_tpu_torch.parallel.mesh import mesh_from_arg
    from raytracer_tpu_torch.parallel.train import (
        apply_params, init_state, make_train_step,
    )
    from raytracer_tpu_torch.render import engine_accel
    from raytracer_tpu_torch.utils.checkpoint import (
        load_train_state, save_train_state,
    )

    fields = tuple(f.strip() for f in args.fields.split(",") if f.strip())
    bad = [f for f in fields if f not in PARAM_FIELDS]
    if bad:
        raise SystemExit(f"unknown fields {bad}; choose from {PARAM_FIELDS}")
    rank = initialize()
    dev = resolve_device(args.device)
    mesh = mesh_from_arg(args.mesh, dev)
    size = 1 if mesh is None else mesh.size
    if mesh is not None:
        dev = mesh.devices[0]
    print(f"Training on {size} device(s) ({dev}), fields={list(fields)}")

    data, meta = load_scene(args.scene, device=dev)
    accel = engine_accel(args.engine, None, data, meta, dev)
    cam = meta.cameras[args.camera]
    if args.downscale > 1:
        cam = dataclasses.replace(
            cam, width=cam.width // args.downscale,
            height=cam.height // args.downscale)
    target = load_target(args.target)
    if target.shape != (cam.height, cam.width, 3):
        raise SystemExit(
            f"target shape {target.shape} != camera resolution "
            f"({cam.height}, {cam.width}, 3); use --downscale to match")

    vec = torch.from_numpy(camera_vectors(cam)).to(dev)
    origin, dirs_all = eye_rays_from(vec, cam.width, cam.height)
    target_all = torch.from_numpy(target.reshape(-1, 3)).to(dev)
    r_total = dirs_all.shape[0]
    batch = (max(args.batch - args.batch % size, size) if args.batch > 0
             else r_total)
    if batch >= r_total:
        # the whole frame (a batch clamped down to it too): its tail that
        # the mesh does not divide is dropped once, not redrawn every step
        drop = r_total % size
        if drop:
            print(f"note: dropping {drop} of {r_total} rays so the frame "
                  f"divides the {size}-device mesh")
            r_total -= drop
            dirs_all, target_all = dirs_all[:r_total], target_all[:r_total]
        batch = r_total

    state = init_state(data, fields=fields)
    if args.checkpoint and os.path.exists(args.checkpoint):
        state = load_train_state(args.checkpoint, state)
        print(f"Resumed train state from {args.checkpoint}")
    ldr = not args.target.lower().endswith(".exr")
    step_fn = make_train_step(meta, lr=args.lr, engine=args.engine, ldr=ldr,
                              device=dev, mesh=mesh)

    rng = np.random.default_rng(args.seed)
    d_dev, t_dev = dirs_all, target_all
    t0 = time.perf_counter()
    loss = float("nan")
    for i in range(args.steps):
        if batch < r_total:
            idx = torch.from_numpy(
                rng.choice(r_total, size=batch, replace=False)).to(dev)
            d_dev, t_dev = dirs_all[idx], target_all[idx]
        state, loss = step_fn(state, data, origin, d_dev, t_dev, accel=accel)
        if (i + 1) % args.log_every == 0 or i == 0:
            print(f"step {i + 1:5d}  loss {float(loss):.6f}  "
                  f"({(time.perf_counter() - t0) / (i + 1):.3f} s/step)",
                  flush=True)
        if (rank == 0 and args.checkpoint
                and (i + 1) % args.checkpoint_every == 0):
            save_train_state(args.checkpoint, state)
    print(f"Final loss: {float(loss):.6f} after {args.steps} steps "
          f"({time.perf_counter() - t0:.1f} s)")
    if rank == 0 and args.checkpoint:
        save_train_state(args.checkpoint, state)
        print(f"Saved train state to {args.checkpoint}")

    if rank == 0 and args.out:
        from raytracer_tpu_torch.models.whitted import render_camera
        from raytracer_tpu_torch.ops.image import quantize
        from raytracer_tpu_torch.utils.ppm import write_ppm

        recovered = apply_params(
            data, {f: p.detach() for f, p in state.params.items()})
        with torch.no_grad():
            img = quantize(render_camera(recovered, meta, cam, accel,
                                         device=dev, engine=args.engine))
        write_ppm(args.out, img.cpu().numpy())
        print(f"Wrote recovered render to {args.out}")


if __name__ == "__main__":
    main()
