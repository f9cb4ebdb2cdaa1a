"""Run one cell of the benchmark once:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) names a configuration and a traffic mix; the mix names
its driver.  Set-up runs from the start of this process to the first
timed call; the window then runs for ``--seconds``; after it, the
program's outputs are compared with the plain reference
(``benchmark/reference``).  The last line of standard output is the
result: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones, read under
``torch.profiler``), ``device`` and, traced, ``breakdown``; its last key
``checks`` holds each number compared beside its limit, which also end
standard error.

Exits 3 without a result when CUDA is missing or has fewer cards than
the cell asks for, and 4 when a JAX module or the JAX package was
loaded.  The port's only build cache is its kernel library, which it
builds at a fixed path inside the checkout
(``raytracer_tpu_torch/_build/``), so only a checkout's first run builds.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402
from benchmark.paths import Bench  # noqa: E402


def result_line(ctx, bench) -> dict:
    """The run's result (``ctx`` after its driver ran)."""
    metrics = {}
    for m in bench.metrics(ctx.name, ctx.trace_on):
        if ctx.trace_on:
            value = (bench.reader(m["name"])(ctx.trace)
                     if ctx.trace is not None else None)
        elif m["name"] == "setup_s":
            value = ctx.setup_s
        elif m["name"] == "peak_mem_gib":
            value = ctx.peak_bytes / 2**30
        else:
            value = ctx.e2e.get(m["name"])
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = harness.device_record(ctx)
    line = {"correct": ctx.correct, "attempted": ctx.attempted,
            "failed": ctx.failed, "metrics": metrics, "device": device}
    if ctx.trace is not None:
        device["busy_s"] = ctx.trace.busy_ns() / 1e9
        device["window_s"] = ctx.trace.window_s
        line["breakdown"] = {
            "device_ops": [[n, s] for n, s in harness.device_ops(ctx.trace)[:10]],
            "idle_gaps": [[n, s] for n, s in harness.idle_gaps(ctx.trace)[:10]]}
    # a number that is not finite fails its check and is written null
    line["checks"] = {c.name: {"value": c.value if math.isfinite(c.value)
                               else None, "limit": c.limit}
                      for c in ctx.checks}
    return line


def run(workload: str, seed: int, seconds: float, trace: bool,
        bench=None, device: str = "cuda", **overrides) -> dict:
    """One run in this process; the result line.  ``device`` "cpu" and the
    ``overrides`` (``config``, ``traffic``, ``limits``, ``work_dir``) are
    for the benchmark's own tests."""
    bench = bench or Bench(ROOT)
    ctx = harness.Context(bench, workload, seed, seconds, trace, T_START,
                          device, **overrides)
    driver = bench.load_module("drivers", ctx.traffic["driver"])
    driver.run(ctx)
    return result_line(ctx, bench)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = Bench(ROOT)
    chips = bench.workload(args.workload)["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"the cell needs {chips} CUDA device(s); the machine "
                    f"has {torch.cuda.device_count()}")
        return 3
    line = run(args.workload, args.seed, args.seconds, bool(args.trace),
               bench)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"forbidden modules were loaded: {found}")
        return 4
    for name, c in line["checks"].items():
        harness.log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
