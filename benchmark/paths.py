"""Where the benchmark finds its parts: every configuration, traffic mix,
driver, per-layer metric and limit by its name in ``BENCHMARK.json``, so
that a cell, a mix or a metric is added as files and entries alone.

    benchmark/configs/<config>.json     sizes, source, assumed, reduced
    benchmark/scenes/<config>.py        generate(seed, config) -> scene
    benchmark/traffic/<mix>.json        parameters; "driver" names:
    benchmark/drivers/<driver>.py       run(ctx) -> Outcome
    benchmark/metrics/<metric>.py       read(trace) -> number or None
    benchmark/limits/<workload>.json    the correctness limits of a cell
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Bench:
    """``BENCHMARK.json`` under ``root`` and the files it names."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.dir = os.path.join(root, "benchmark")
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)

    def _file(self, kind: str, name: str, ext: str) -> str:
        return os.path.join(self.dir, kind, name + ext)

    def load_json(self, kind: str, name: str) -> dict:
        with open(self._file(kind, name, ".json")) as f:
            return json.load(f)

    def load_module(self, kind: str, name: str):
        path = self._file(kind, name, ".py")
        mod_name = "benchmark_" + kind + "_" + re.sub(r"\W", "_", name)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
        return mod

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return self.load_json("configs", name)

    def traffic(self, name: str) -> dict:
        return self.load_json("traffic", name)

    def limits(self, workload: str) -> dict:
        return self.load_json("limits", workload)

    def metrics(self, workload: str, trace: bool) -> list:
        """The metric entries the cell reports: its end-to-end ones with
        ``trace`` 0, its per-layer ones with 1 (an entry without
        ``workloads`` belongs to every cell that reports its ``moves``)."""
        e2e = [m for m in self.spec["end_to_end"]
               if workload in m.get("workloads", [workload])]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if workload in m.get("workloads", [])
                or ("workloads" not in m and m["moves"] in names)]

    def reader(self, metric: str):
        """The per-layer metric's reader: ``read(trace) -> float | None``."""
        return self.load_module("metrics", metric).read
