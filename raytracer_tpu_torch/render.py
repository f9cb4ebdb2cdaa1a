"""Command line: ``python -m raytracer_tpu_torch.render scene.xml [options]``.

Port of ``raytracer_tpu/render.py``: loads the scene, builds the
engine's accelerator ("plants trees": the clusters, or loads them from
``--accel-cache``, for ``--engine cluster`` and ``auto``; the BVH with its
octant threads for ``bvh``; nothing for ``brute``), renders every camera
and writes one image per camera (PPM, PNG or EXR), printing per-phase
timings and ray throughput.  SSAA
defaults to the reference's 2x per dimension; ``--ssaa 1`` is
golden-parity mode.  Runs on the GPU unless ``--device cpu``.

``--mesh auto|N`` splits every band's rays over a device mesh
(``parallel.mesh.mesh_from_arg``: every card of the process by default),
after bringing up ``torch.distributed`` when torchrun's environment is
set (``parallel.distributed.initialize``); every rank then holds the
whole image and rank 0 alone writes it.  ``--profile DIR`` writes a
``torch.profiler`` trace of the render loop into DIR
(``trace_rank<R>.json``), with the port's spans (``tracing``) merged in
as ``X`` events on the main thread's row and its wave counters as ``C``
events: ``pipeline.frame``, ``.upload``, ``.band``, ``.assemble``,
``.to_host``, ``.write``; ``program.step`` (a replay, its step's name in
``args``), ``program.flags`` (a flag read, one device sync),
``program.make``, ``.first``, ``.capture`` (construction, a step's
first eager run, its capture); ``backend.load``; the counters
``wave.active`` and ``wave.lanes``.  ``--debug-nans`` checks every
wave's radiance (``models.whitted.debug_nans``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import torch

from raytracer_tpu_torch import tracing
from raytracer_tpu_torch.backend import resolve_device
from raytracer_tpu_torch.models.bvh import build_bvh, device_bvh
from raytracer_tpu_torch.models.clusters import build_clusters
from raytracer_tpu_torch.models.scene import load_scene
from raytracer_tpu_torch.models.whitted import debug_nans, resolve_engine
from raytracer_tpu_torch.ops.image import TONE_MODES
from raytracer_tpu_torch.parallel.distributed import initialize
from raytracer_tpu_torch.parallel.mesh import mesh_from_arg
from raytracer_tpu_torch.pipeline import (
    FORMATS, SSAA_MODES, render_one_camera, write_image,
)
from raytracer_tpu_torch.utils.checkpoint import (
    load_accel, save_accel, scene_digest,
)


def accel_for(path, data, meta, dev, save: bool = True):
    """The scene's clusters: loaded from the accel cache ``path`` when it
    was saved for this scene (its ``scene_digest``), else built (and saved
    to ``path`` when given and ``save``: under torchrun rank 0 alone
    writes it).  A cache that cannot be read, is of another version or was
    saved for other scene arrays is rebuilt and overwritten, with a
    note."""
    digest = scene_digest(data) if path else None
    if path and os.path.exists(path):
        try:
            return load_accel(path, device=dev, digest=digest)[1]
        except ValueError as e:
            print(f"note: rebuilding the accel cache: {e}")
    bvh = build_bvh(data, meta)
    clusters = build_clusters(data, meta, bvh)
    if path and save:
        save_accel(path, bvh, clusters, digest)
    return clusters


def engine_accel(engine, cache, data, meta, dev, save: bool = True):
    """The accelerator of ``engine``: the clusters (``accel_for``, with
    the accel cache) for cluster and auto, the BVH with its octant threads
    on ``dev`` for bvh, None for brute; built in the set-up span
    ``accel.build``."""
    if engine == "brute":
        return None
    with tracing.setup_span("accel.build", engine):
        if engine == "bvh":
            if cache:
                print("note: --accel-cache is read and written by the "
                      "cluster engine only")
            return device_bvh(build_bvh(data, meta, ordered=True), dev)
        return accel_for(cache, data, meta, dev, save)


def render_camera_cli(args, data, meta, cam, accel, engine, dev, mesh,
                      rank) -> float:
    """One camera of the CLI: render, print its timings (and the
    ``--json-metrics`` line), write its image on rank 0; returns the
    render's seconds."""
    rcam = cam.scaled(args.ssaa) if args.ssaa > 1 else cam
    if args.ssaa_mode == "adaptive":
        rcam = cam  # adaptive samples at the final resolution
    print(f"Rendering {cam.image_name} "
          f"({rcam.width}x{rcam.height}, engine={engine})...")
    t2 = time.perf_counter()
    img, adaptive_stats = render_one_camera(
        data, meta, cam, accel, ssaa=args.ssaa, engine=engine,
        ssaa_mode=args.ssaa_mode, bfc=args.bfc, chunk=args.chunk,
        tone=args.tone, hdr=args.format == "exr", seed=args.seed,
        adaptive_frac=args.adaptive_frac,
        adaptive_extra=args.adaptive_extra,
        adaptive_rounds=args.adaptive_rounds,
        relaxed=args.relaxed_parity, device=dev, mesh=mesh)
    t3 = time.perf_counter()  # the image is on the host: synced
    rays = rcam.width * rcam.height
    print(f"  {t3 - t2:.3f} s, {rays / (t3 - t2) / 1e6:.2f} Mrays/s (primary)")
    if args.json_metrics:
        line = {
            "camera": cam.image_name,
            "width": rcam.width, "height": rcam.height,
            "primary_rays": rays,
            "render_s": round(t3 - t2, 4),
            "mrays_per_s": round(rays / (t3 - t2) / 1e6, 3),
            "engine": engine, "ssaa": args.ssaa,
            "device": str(dev), "mesh": 1 if mesh is None else mesh.size,
            "n_tris": meta.n_tris, "n_spheres": meta.n_spheres,
            "max_depth": meta.max_depth, "lights": meta.n_lights,
        }
        if adaptive_stats is not None:
            line["adaptive"] = adaptive_stats
        print(json.dumps(line))
    if rank == 0:
        # one writer: every rank holds the whole image after the gather
        write_image(args.out_dir, cam.image_name, img, args.format)
    return t3 - t2


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Whitted ray tracer on PyTorch and CUDA")
    ap.add_argument("scene", help="scene XML (CENG477 format)")
    ap.add_argument("--ssaa", type=int, default=2,
                    help="supersampling factor per dimension (1 = off)")
    ap.add_argument("--ssaa-mode", choices=list(SSAA_MODES), default="parity",
                    help="parity: uint8 truncating box filter like the "
                         "reference; mean: float mean before quantization; "
                         "jitter: jittered sub-pixel samples and the float "
                         "mean; adaptive: every pixel gets ssaa^2 samples, "
                         "the noisiest --adaptive-frac of pixel blocks "
                         "--adaptive-extra more (ops/adaptive.py)")
    ap.add_argument("--adaptive-frac", type=float, default=0.125,
                    help="adaptive mode: fraction of pixel blocks refined")
    ap.add_argument("--adaptive-extra", type=int, default=None,
                    help="adaptive mode: extra samples for refined blocks "
                         "(default 3x the base ssaa^2; split across "
                         "--adaptive-rounds)")
    ap.add_argument("--adaptive-rounds", type=int, default=1,
                    help="adaptive mode: refinement passes, each re-scoring "
                         "block variance from the samples so far")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the jitter and adaptive sample offsets "
                         "(jax.random's threefry draws, so the JAX package's "
                         "image for the same seed; on the CPU and on CUDA)")
    ap.add_argument("--engine", choices=["auto", "brute", "bvh", "cluster"],
                    default="auto",
                    help="visibility engine: cluster (the CUDA kernels; "
                         "auto's choice here), bvh (a lockstep walk of the "
                         "BVH) or brute (every ray against every primitive)")
    ap.add_argument("--relaxed-parity", action="store_true",
                    help="sqrt/div-free sphere occlusion sign tests in the "
                         "shadow kernel (grazing-sphere pairs may flip "
                         "isolated shadow bits under f32 rounding)")
    ap.add_argument("--bfc", action="store_true",
                    help="cull backfacing triangles (the TA golden semantics)")
    ap.add_argument("--chunk", type=int, default=1 << 22,
                    help="most rays per wavefront; a larger frame (after "
                         "SSAA) renders in row bands of about this many rays")
    ap.add_argument("--accel-cache", metavar="PATH", default=None,
                    help="load the BVH and clusters from PATH if they were "
                         "saved there for this scene's geometry, else build "
                         "them and save them there (the JAX package's npz "
                         "layout, with a scene digest)")
    ap.add_argument("--out-dir", default=".", help="output directory")
    ap.add_argument("--format", choices=list(FORMATS), default="ppm",
                    help="ppm (the scene's declared name), png (8-bit RGB) "
                         "or exr (linear float radiance before quantization, "
                         "half floats; SSAA reduces as a float mean)")
    ap.add_argument("--tone", choices=list(TONE_MODES), default="none",
                    help="tone curve on linear radiance before 8-bit output "
                         "(ppm/png; exr stays linear)")
    ap.add_argument("--repeat", type=int, default=1,
                    help="render repetitions for benchmarking")
    ap.add_argument("--json-metrics", action="store_true",
                    help="print one structured JSON metrics line per camera")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default; the CUDA kernels) or cpu (the plain "
                         "PyTorch versions)")
    ap.add_argument("--mesh", default="auto", metavar="auto|N",
                    help="device mesh: auto (default) splits each band's rays "
                         "over every card of the process; N over N shards of "
                         "all processes (on the CPU, N logical shards); 1 = "
                         "one device.  Under torchrun each process takes its "
                         "card and rank 0 writes the images")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write a torch.profiler trace of the render loop "
                         "into DIR (trace_rank<R>.json), the port's spans "
                         "and wave counters merged in")
    ap.add_argument("--debug-nans", action="store_true",
                    help="check every wave's radiance after each bounce and "
                         "raise FloatingPointError naming the band and bounce "
                         "of the first value that is not finite (one device "
                         "sync a bounce; autograd anomaly mode on).  The "
                         "port's counterpart of the JAX CLI's jax_debug_nans, "
                         "not the same switch: that one checks every op")
    args = ap.parse_args(argv)
    rank = initialize()
    dev = resolve_device(args.device)
    mesh = mesh_from_arg(args.mesh, dev)
    if mesh is not None:
        dev = mesh.devices[0]
        print(f"Rendering with {mesh.size} devices ({dev.type}).")
    os.makedirs(args.out_dir, exist_ok=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    data, meta = load_scene(args.scene, device=dev)
    t0 = time.perf_counter()
    accel = engine_accel(args.engine, args.accel_cache, data, meta, dev,
                         save=rank == 0)
    engine = resolve_engine(args.engine, accel, meta)
    sync()
    t1 = time.perf_counter()
    print(f"Planted trees in {t1 - t0:.3f} seconds.")
    if args.ssaa > 1:
        print(f"Super Sampling Anti aliasing is enabled. ({args.ssaa}*{args.ssaa}x)")
    elif args.ssaa_mode in ("mean", "jitter"):
        print(f"note: --ssaa-mode {args.ssaa_mode} has no effect at "
              "--ssaa 1 (supersampling is off)")

    t_render = 0.0
    profile = contextlib.nullcontext()
    if args.profile:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profile = torch.profiler.profile(activities=acts)
    with profile as prof, debug_nans(args.debug_nans):
        for _ in range(args.repeat):
            for cam in meta.cameras:
                t_render += render_camera_cli(args, data, meta, cam, accel,
                                              engine, dev, mesh, rank)
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        path = os.path.join(args.profile, f"trace_rank{rank}.json")
        prof.export_chrome_trace(path)
        added = tracing.merge_chrome_trace(path)
        print(f"Wrote the profiler trace to {path} ({added} spans and "
              "counter samples of the port)")
    print(f"Rendered in {t_render / args.repeat:.3f} seconds.")
    print(f"Total: {t_render / args.repeat + (t1 - t0):.3f} seconds.")


if __name__ == "__main__":
    main()
