"""Shared pieces of the benchmark's own tests: the checkout on the path,
and configurations and mixes cut to sizes a CPU test run holds."""

from __future__ import annotations

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.paths import Bench  # noqa: E402

# scene sizes for CPU runs: every shape of the configuration but its scale
SMALL = {"horse31k": dict(cells=12, triangles=270, width=48, height=32),
         "marbles650": dict(grid=[12, 10], width=32, height=32)}


@pytest.fixture
def bench():
    return Bench(ROOT)


def small_config(bench, name: str) -> dict:
    cfg = copy.deepcopy(bench.config(name))
    cfg["scene"].update(SMALL[name])
    return cfg


def small_traffic(bench, name: str) -> dict:
    tr = copy.deepcopy(bench.traffic(name))
    tr.update({"frame": dict(warmup_frames=1, check_tiles=3, check_frames=2,
                             trace_after=0.0, trace_frames=2),
               "train": dict(warmup_steps=1, trace_after=0.0, trace_steps=2,
                             ref_tile=[16, 16])}[tr["driver"]])
    return tr


def run_small(bench, workload: str, tmp_path, seconds=1.0, trace=False,
              seed=2**31 + 11):
    """One CPU run of ``workload`` at the small sizes: its result line."""
    from benchmark import run

    wl = bench.workload(workload)
    return run.run(workload, seed, seconds, trace, bench, device="cpu",
                   config=small_config(bench, wl["config"]),
                   traffic=small_traffic(bench, wl["traffic"]),
                   work_dir=str(tmp_path))
