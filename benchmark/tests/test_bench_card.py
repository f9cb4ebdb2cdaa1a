"""On the card: one short run of each cell through the command line,
correct, with its end-to-end metrics (``python -m pytest benchmark/tests
-m gpu`` on a machine with a CUDA card; skipped without one)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import ROOT

CELLS = ["horse31k.frame-ssaa2", "marbles650.frame-ssaa2",
         "horse31k.train-1m"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark runs on one")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_on_the_card(card, bench, workload):
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", str(2**31 + 99), "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"], line
    assert line["device"]["platform"] == "gpu"
    names = {m["name"] for m in bench.metrics(workload, False)}
    assert set(line["metrics"]) == names
