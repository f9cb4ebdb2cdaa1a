"""Captures made inside a benchmark cell's measured window, on the card:

    python3 experiments/window_captures.py --workload W --seed N \
        [--seconds 20]

Runs the cell once in this process (``benchmark/run.py``'s ``run``) and
prints one JSON line: the programs' captures (``programs.stats``) at the
end of set-up and at the end of the run, and every ``program.first`` /
``program.capture`` span that began after set-up ended (the step it
named, its seconds, when it began in the window).  A cell whose window
captures measures a step's first eager run and its capture as frame
time."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    from benchmark import harness, run
    from raytracer_tpu_torch import tracing
    from raytracer_tpu_torch.models import programs

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    mark = {}
    done = harness.Context.setup_done

    def setup_done(ctx):
        done(ctx)
        mark.update(captures=programs.stats["captures"], ns=time.time_ns())

    harness.Context.setup_done = setup_done
    run.T_START = T_START
    line = run.run(args.workload, args.seed, args.seconds, False)
    late = [{"span": s.name, "what": str(s.what),
             "s": (s.end - s.start) / 1e9,
             "at_s": (s.start - mark["ns"]) / 1e9}
            for s in list(tracing.spans)
            if s.name in ("program.first", "program.capture")
            and s.start >= mark["ns"]]
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "frames": line["attempted"], "correct": line["correct"],
                      "captures_at_setup": mark["captures"],
                      "captures_at_end": programs.stats["captures"],
                      "in_window": late}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
