"""Command line: ``python -m raytracer_tpu_torch.render scene.xml [options]``.

Port of ``raytracer_tpu/render.py`` on the cluster engine: loads the
scene, builds the BVH and clusters ("plants trees"), renders every camera
and writes one PPM per camera, printing per-phase timings and ray
throughput.  SSAA defaults to the reference's 2x per dimension; ``--ssaa
1`` is golden-parity mode.  Runs on the GPU unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from raytracer_tpu_torch.backend import resolve_device
from raytracer_tpu_torch.models.bvh import build_bvh
from raytracer_tpu_torch.models.clusters import build_clusters
from raytracer_tpu_torch.models.scene import load_scene
from raytracer_tpu_torch.pipeline import (
    SSAA_MODES, render_one_camera, write_image,
)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Whitted ray tracer on PyTorch and CUDA")
    ap.add_argument("scene", help="scene XML (CENG477 format)")
    ap.add_argument("--ssaa", type=int, default=2,
                    help="supersampling factor per dimension (1 = off)")
    ap.add_argument("--ssaa-mode", choices=list(SSAA_MODES), default="parity",
                    help="parity: uint8 truncating box filter like the "
                         "reference; mean: float mean before quantization")
    ap.add_argument("--relaxed-parity", action="store_true",
                    help="sqrt/div-free sphere occlusion sign tests in the "
                         "shadow kernel (grazing-sphere pairs may flip "
                         "isolated shadow bits under f32 rounding)")
    ap.add_argument("--bfc", action="store_true",
                    help="cull backfacing triangles (the TA golden semantics)")
    ap.add_argument("--chunk", type=int, default=1 << 22,
                    help="most rays per frame; larger frames take the "
                         "streamed band renderer, not ported yet (ROADMAP "
                         "queue 1 row 11), and raise")
    ap.add_argument("--out-dir", default=".", help="output directory")
    ap.add_argument("--repeat", type=int, default=1,
                    help="render repetitions for benchmarking")
    ap.add_argument("--json-metrics", action="store_true",
                    help="print one structured JSON metrics line per camera")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default; the CUDA kernels) or cpu (the plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    data, meta = load_scene(args.scene, device=dev)
    t0 = time.perf_counter()
    clusters = build_clusters(data, meta, build_bvh(data, meta))
    sync()
    t1 = time.perf_counter()
    print(f"Planted trees in {t1 - t0:.3f} seconds.")
    if args.ssaa > 1:
        print(f"Super Sampling Anti aliasing is enabled. ({args.ssaa}*{args.ssaa}x)")
    elif args.ssaa_mode == "mean":
        print("note: --ssaa-mode mean has no effect at --ssaa 1 "
              "(supersampling is off)")

    t_render = 0.0
    for _ in range(args.repeat):
        for cam in meta.cameras:
            rcam = cam.scaled(args.ssaa) if args.ssaa > 1 else cam
            print(f"Rendering {cam.image_name} "
                  f"({rcam.width}x{rcam.height}, engine=cluster)...")
            t2 = time.perf_counter()
            img = render_one_camera(
                data, meta, cam, clusters, ssaa=args.ssaa,
                ssaa_mode=args.ssaa_mode, bfc=args.bfc, chunk=args.chunk,
                relaxed=args.relaxed_parity, device=dev)
            t3 = time.perf_counter()  # the image is on the host: synced
            t_render += t3 - t2
            rays = rcam.width * rcam.height
            print(f"  {t3 - t2:.3f} s, {rays / (t3 - t2) / 1e6:.2f} Mrays/s (primary)")
            if args.json_metrics:
                print(json.dumps({
                    "camera": cam.image_name,
                    "width": rcam.width, "height": rcam.height,
                    "primary_rays": rays,
                    "render_s": round(t3 - t2, 4),
                    "mrays_per_s": round(rays / (t3 - t2) / 1e6, 3),
                    "engine": "cluster", "ssaa": args.ssaa,
                    "device": str(dev),
                    "n_tris": meta.n_tris, "n_spheres": meta.n_spheres,
                    "max_depth": meta.max_depth, "lights": meta.n_lights,
                }))
            write_image(args.out_dir, cam.image_name, img)
    print(f"Rendered in {t_render / args.repeat:.3f} seconds.")
    print(f"Total: {t_render / args.repeat + (t1 - t0):.3f} seconds.")


if __name__ == "__main__":
    main()
