#!/usr/bin/env python3
"""Which of the port's kernels ``torch.profiler`` lists as device events.

    python3 experiments/torch_profiler_draw.py [--out DIR]

On one card: profiles 5 runs each of the threefry jitter draw alone
(``ops.camera.draw_jitter``, 8,388,608 floats: a full-width SSAA 2
band), the same draw inside ``torch.profiler.record_function``, and a
flat-mask launch (``ops.kernels.ray_mask``, a kernel of the same library
launched the same way) as the control, and two draws in one window; for
each run it prints the device events of ``prof.events()`` by name and the
kernel names of the exported chrome trace (written under ``--out``), as
one JSON line each.  Then a jittered 64x64 terrain frame at --ssaa 2 in
4 bands, replayed as CUDA graphs (its band program draws in its
prologue, 4 draws a frame), 3 runs; then the draw again (3 runs each)
after that frame's replays, and after 20 more profiler sessions of it.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from raytracer_tpu_torch import backend
    from raytracer_tpu_torch.ops import kernels as K
    from raytracer_tpu_torch.ops.camera import draw_jitter

    backend.kernels()
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), torch.__version__, flush=True)
    gen = torch.Generator().manual_seed(0)
    nt, c = 64, 256
    act = torch.ones(nt, dtype=torch.int32, device=dev)
    box = torch.rand((8, c), generator=gen).to(dev)
    bundle = torch.rand((8, nt * K.TILE), generator=gen).to(dev)

    def draw():
        return draw_jitter(None, 0, ("band", 0), (2048, 2048, 2), dev)

    def draw_scoped():
        with record_function("threefry draw"):
            return draw()

    def mask():
        return K.ray_mask(act, box, bundle)

    def two_draws():
        draw()
        return draw()

    from raytracer_tpu_torch.models.bvh import build_bvh
    from raytracer_tpu_torch.models.clusters import build_clusters
    from raytracer_tpu_torch.pipeline import render_one_camera
    from raytracer_tpu_torch.utils.synth import terrain_scene

    data, meta = terrain_scene(cells=16, res=64, mirror_stripes=True,
                               device=dev)
    cset = build_clusters(data, meta, build_bvh(data, meta))

    def frame():
        return render_one_camera(data, meta, meta.cameras[0], cset, ssaa=2,
                                 ssaa_mode="jitter", chunk=128 * 32,
                                 device=dev)

    def replays():
        for _ in range(3):
            frame()

    def sessions():
        for _ in range(20):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                frame()
                torch.cuda.synchronize()

    os.makedirs(args.out, exist_ok=True)
    stages = ((None, "draw", draw, 5),
              (None, "draw in record_function", draw_scoped, 5),
              (None, "ray_mask", mask, 5),
              (None, "two draws", two_draws, 3),
              (None, "frame of 4 bands", frame, 3),
              (replays, "draw after graph replays", draw, 3),
              (sessions, "draw after 20 profiled frames", draw, 3))
    for before, what, fn, runs in stages:
        if before is not None:
            before()
        for i in range(runs):
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            events = collections.Counter(
                ev.name[:60] for ev in prof.events()
                if ev.device_type == DeviceType.CUDA)
            path = os.path.join(args.out,
                                f"profile_{what.replace(' ', '_')}_{i}.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
            kernels = collections.Counter(
                e.get("name", "")[:60] for e in trace.get("traceEvents", [])
                if e.get("cat") == "kernel")
            print(json.dumps({"run": what, "i": i, "events": events,
                              "trace_kernels": kernels}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
