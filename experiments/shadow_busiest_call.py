#!/usr/bin/env python3
"""Time the shadow kernel at the busiest shadow call of one eager frame of
each named benchmark cell, on one card.

    python3 experiments/shadow_busiest_call.py [--root DIR]
        [--cells flake66k.frame-ssaa2,marbles650.frame-ssaa2] [--seed N]

``--root`` is the checkout whose package, ``chip_smoke.py`` and benchmark
run (default: this one), so one call can time a parent commit unpacked
beside this one.  Per cell: frame 0 of the cell's camera sweep at its
configuration, rendered eagerly through ``render_one_camera`` while
``chip_smoke.Capture`` keeps the shadow call with the most listed visits;
then the kernel's ms per launch over 10 launches behind a device spin
(``chip_smoke.time_call``), the plain version's ms (one launch), the call's
bound (``chip_smoke.work``: operations at the issue rate, bytes at 3.35
TB/s, every ray of the call counted), and where the kernel takes a tally,
its sphere walks' slots and live rays.  Prints a JSON line per cell.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--cells",
                    default="flake66k.frame-ssaa2,marbles650.frame-ssaa2")
    ap.add_argument("--seed", type=int, default=2**31 + 11)
    a = ap.parse_args()
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)

    import torch

    import chip_smoke as cs
    from benchmark import sceneio
    from benchmark.drivers.frame import camera_at, port_camera
    from benchmark.paths import Bench
    from raytracer_tpu_torch.models.scene import from_parsed
    from raytracer_tpu_torch.models.whitted import eager
    from raytracer_tpu_torch.ops import kernels as K
    from raytracer_tpu_torch.pipeline import render_one_camera
    from raytracer_tpu_torch.render import engine_accel

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True).stdout.strip()
    bench = Bench(root)
    for name in a.cells.split(","):
        cell = next(w for w in bench.spec["workloads"] if w["name"] == name)
        tr = bench.traffic(cell["traffic"])
        parsed = sceneio.generate(bench, bench.config(cell["config"]), a.seed)
        data, meta = from_parsed(parsed, "cuda")
        accel = engine_accel(tr["engine"], None, data, meta, "cuda")
        cam = port_camera(camera_at(parsed["cameras"][tr["camera"]], 0, tr))
        with eager(), cs.Capture(K) as cap:
            render_one_camera(data, meta, cam, accel, ssaa=tr["ssaa"],
                              ssaa_mode=tr["ssaa_mode"], chunk=tr["chunk"],
                              engine=tr["engine"], device="cuda")
        args = cap.calls["shadow"]
        ops, byt = cs.work("shadow", args)
        out = {"root": root, "cell": name, "card": card,
               "rays": int(args[7].shape[0]), "lights": int(args[8].shape[0]),
               "ms": cs.time_call(K.shadow, args, 10),
               "plain_ms": cs.time_once(K.shadow_plain, args),
               "bound_ms": 1e3 * max(ops / cs.PEAK_ISSUE, byt / cs.PEAK_BYTES),
               "ops": ops, "bytes": byt}
        if len(args) > 12:
            tally = torch.zeros(2, dtype=torch.int64, device="cuda")
            K.shadow(*args[:12], tally)
            out["slots"], out["live"] = tally.tolist()
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
