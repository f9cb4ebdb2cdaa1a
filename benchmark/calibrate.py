"""Readings that set the benchmark's fixed numbers, run once on the chip
when a cell is defined (the benchmark's own runs never run them):

    python3 benchmark/calibrate.py sound --workload W --seeds 1,2,3 \
        --seconds 3
        sound runs of the cell in one process, a fresh set-up and window
        for each seed: the numbers that decide ``correct``;

    python3 benchmark/calibrate.py control --workload W --seeds 1,2,3 \
        --seconds 20
        the control of ``correct``: the plain reference computed in
        bfloat16 (the precision below the configuration's float32) put in
        the program's place, compared with the reference in float32 by
        the cell's own numbers at the cell's own size.  For the training
        cell, after a set-up and a window of ``--seconds`` of the program
        for each seed (its state after the window is where the last
        checked steps start): the program's own numbers, the control's,
        and those of the fault "half of the batch left out, the mean over
        the rest".

Each prints one JSON line per reading.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from benchmark import harness, imagecheck, sceneio  # noqa: E402
from benchmark.paths import Bench  # noqa: E402

# the frames a frame cell's window holds, about (its sample's range)
NOMINAL_FRAMES = 400


def _image_control(ctx, seed: int, shots) -> dict:
    """bfloat16 against float32 reference tiles of ``shots`` ((camera
    dict, ssaa) per checked image), drawn as a run draws them."""
    import torch

    from benchmark.reference import whitted as ref

    parsed = sceneio.generate(ctx.bench, ctx.config, seed)
    rng = np.random.default_rng(abs(seed))
    hi = ref.Scene(parsed, ctx.device)
    lo = ref.Scene(parsed, ctx.device, torch.bfloat16)
    tally = imagecheck.Tally()
    for cam, ssaa in shots(parsed, rng):
        tiles = imagecheck.sample_tiles(rng, cam["height"], cam["width"],
                                        ctx.traffic["check_tiles"])
        a = ref.tiles_image(hi, cam, ssaa, tiles, imagecheck.TILE).cpu().numpy()
        b = ref.tiles_image(lo, cam, ssaa, tiles, imagecheck.TILE).cpu().numpy()
        image = np.zeros((cam["height"], cam["width"], 3), np.uint8)
        for (r, c), t in zip(tiles, b):
            image[r:r + imagecheck.TILE, c:c + imagecheck.TILE] = t
        tally.add(a, image, tiles)
    ctx.checks = []
    tally.report(ctx)
    return {c.name: c.value for c in ctx.checks}


def frame_shots(ctx):
    from benchmark.drivers.frame import camera_at

    tr = ctx.traffic

    def shots(parsed, rng):
        cam0 = parsed["cameras"][tr["camera"]]
        picks = rng.choice(NOMINAL_FRAMES, size=tr["check_frames"],
                           replace=False)
        return [(camera_at(cam0, int(k), tr), tr["ssaa"])
                for k in sorted(picks)]
    return shots


def train_control(ctx, seed: int) -> dict:
    """The training cell's numbers, both checked runs, for the program,
    for the reference in bfloat16 and for the reference fed half of the
    batch, each against the float32 reference on all of it."""
    import torch

    from benchmark.drivers import train as drv

    ctx.seed = seed
    s = drv.setup(ctx)
    drv.window(ctx, s)
    base = drv.reference(ctx, s)
    half = slice(0, s.d_ref.shape[0] // 2)
    runs = {"program": (s.first, s.end),
            "bf16": drv.reference(ctx, s, torch.bfloat16),
            "half": drv.reference(ctx, s, rays=half)}
    out = {"steps": ctx.attempted, "adam_step": s.end.start.t,
           "losses": {"program": s.end.losses, "reference": base[1].losses},
           # per leaf: the first gradient's and the change's norms
           "norms": {name: {k: [float(np.linalg.norm(run.grads[0][k])),
                                float(np.linalg.norm(run.change[k]))]
                            for k in run.change}
                     for name, run in (("start_ref", base[0]),
                                       ("end_ref", base[1]),
                                       ("end_program", s.end))}}
    for name, pair in runs.items():
        out[name] = {}
        for prefix, got, ref in zip(("", "end_"), pair, base):
            out[name].update({prefix + k: v for k, v in
                              drv.numbers(got, ref, base[0]).items()})
    return out


def sound(bench, workload: str, seeds, seconds: float, device: str) -> None:
    for seed in seeds:
        ctx = harness.Context(bench, workload, seed, seconds, False,
                              time.perf_counter(), device)
        bench.load_module("drivers", ctx.traffic["driver"]).run(ctx)
        print(json.dumps({"workload": workload, "seed": seed,
                          "attempted": ctx.attempted,
                          **{c.name: c.value for c in ctx.checks}}),
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("sound", "control"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1,2,3")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = Bench(ROOT)
    seeds = [int(x) for x in args.seeds.split(",")]
    if args.what == "sound":
        sound(bench, args.workload, seeds, args.seconds, args.device)
        return 0
    ctx = harness.Context(bench, args.workload, seeds[0], args.seconds,
                          False, 0.0, args.device)
    driver = ctx.traffic["driver"]
    for seed in seeds:
        if driver == "train":
            line = train_control(ctx, seed)
        else:
            line = {"bf16": _image_control(ctx, seed, frame_shots(ctx))}
        print(json.dumps({"workload": args.workload, "seed": seed, **line}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
