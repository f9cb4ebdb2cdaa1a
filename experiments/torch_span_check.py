"""One traced run of a benchmark cell in this process, then the port's
spans (``raytracer_tpu_torch.tracing``) held against the profiler's
events of the traced stretch, on the card:

    python3 experiments/torch_span_check.py --workload horse31k.frame-ssaa2 \
        --seed 2147483659 --seconds 20

Prints one JSON line: every ``program.flags`` span of the stretch and how
many enclose the host event of their copy (``cudaMemcpyAsync`` or
``aten::_local_scalar_dense``), with the least margins on either side;
the stretch's device-idle ms a frame by the layer of the innermost port
span open (``benchmark/port_spans.py``; ``null`` is outside every span)
beside the idle ms a frame that ``device.idle_share.render`` implies; the
traced frame's ms; and the set-up spans' self seconds beside
``setup_s``."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

COPIES = ("cudaMemcpyAsync", "aten::_local_scalar_dense")


def report(ctx) -> dict:
    """The checks of a traced run's context (after its driver ran)."""
    from benchmark import harness, port_spans
    from raytracer_tpu_torch import tracing

    t = ctx.trace
    a, b = t.window
    kind = "frame" if t.units("frame") else "step"
    units = t.units(kind)
    copies = [(s, e) for n, s, e, _ in t.host if n in COPIES]
    flags = [s for s in tracing.spans
             if s.name == "program.flags" and a <= s.start <= b]
    margins = []
    for s in flags:
        inside = [(c0 - s.start, s.end - c1) for c0, c1 in copies
                  if s.start <= c0 and c1 <= s.end]
        if inside:
            margins.append(min(inside))
    spans = [s for s in tracing.spans if s.end > a and s.start < b]
    idle = port_spans.idle_ns_by_layer(t, spans)
    share = harness.idle_share(t)
    out = {
        "workload": ctx.name, "seed": ctx.seed,
        "device": harness.device_record(ctx)["kind"],
        "units": units, "unit_ms": t.window_s * 1e3 / units,
        "flag_spans": len(flags), "flag_spans_enclosing_copy": len(margins),
        "least_margin_us": ([min(m[0] for m in margins) / 1e3,
                             min(m[1] for m in margins) / 1e3]
                            if margins else None),
        "idle_ms_per_unit": {str(k): v / 1e6 / units
                             for k, v in idle.items()},
        "idle_share_ms_per_unit": (share and share / 100 * t.window_s
                                   * 1e3 / units),
        "setup_s": ctx.setup_s,
        "setup_self_s": dict(tracing.totals),
        "correct": ctx.correct,
    }
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args()

    from benchmark import harness
    from benchmark.paths import Bench

    bench = Bench(ROOT)
    ctx = harness.Context(bench, args.workload, args.seed, args.seconds,
                          True, T_START)
    bench.load_module("drivers", ctx.traffic["driver"]).run(ctx)
    print(json.dumps(report(ctx)), flush=True)


if __name__ == "__main__":
    main()
