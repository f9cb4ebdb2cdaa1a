#!/usr/bin/env python3
"""Frame times and peak device memory of the port's render paths, for an
A/B of two trees on one card.

    python3 experiments/torch_programs_ab.py --root DIR [--label NAME]

imports ``raytracer_tpu_torch`` from the checkout ``DIR`` (for example
the parent commit unpacked with ``git archive HEAD | tar -x -C
_archive/base``, or ``.``), builds its kernels, and renders through
``render_one_camera`` (the path a user calls) the full-width terrain
(``terrain_scene(cells=126, res=1024, mirror_stripes=True)``) at --ssaa
2, streamed at --ssaa 4, at --ssaa 2 jitter and adaptive, and the big
terrain (``cells=512``) at --ssaa 2: per frame a warm-up, then 5 synced
frames (median ms) with the peak allocated and reserved bytes over them.
Prints one JSON line with the card's name and power limit.  Run the two
trees in turns in one call (A B B A): two calls may land on two cards.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="checkout to import from")
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from raytracer_tpu_torch import backend
    from raytracer_tpu_torch.models.bvh import build_bvh
    from raytracer_tpu_torch.models.clusters import build_clusters
    from raytracer_tpu_torch.pipeline import render_one_camera
    from raytracer_tpu_torch.utils.synth import terrain_scene

    import raytracer_tpu_torch
    if os.path.dirname(os.path.dirname(raytracer_tpu_torch.__file__)) != root:
        raise SystemExit(f"imported {raytracer_tpu_torch.__file__}, not from {root}")
    dev = torch.device("cuda")
    backend.kernels()
    out = {"root": args.label or root, "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), "frames": {}}
    for cells, frames in ((126, {"full_width": dict(ssaa=2),
                                 "streamed_ssaa4": dict(ssaa=4),
                                 "jitter_ssaa2": dict(ssaa=2, ssaa_mode="jitter"),
                                 "adaptive": dict(ssaa=2, ssaa_mode="adaptive")}),
                          (512, {"big": dict(ssaa=2)})):
        data, meta = terrain_scene(cells=cells, res=1024, mirror_stripes=True,
                                   device=dev)
        cset = build_clusters(data, meta, build_bvh(data, meta))
        cam = meta.cameras[0]
        for name, kw in frames.items():
            render_one_camera(data, meta, cam, cset, device=dev, **kw)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                render_one_camera(data, meta, cam, cset, device=dev, **kw)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            out["frames"][name] = {
                "ms": statistics.median(times), "runs_ms": times,
                "peak_allocated": torch.cuda.max_memory_allocated(),
                "reserved": torch.cuda.memory_reserved()}
        del data, cset
        try:                       # the captured programs hold the scene
            from raytracer_tpu_torch.models import programs
        except ImportError:        # a tree without them
            continue
        programs.clear()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
