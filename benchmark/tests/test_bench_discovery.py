"""A configuration, a traffic mix and a per-layer metric are added as
files and entries alone: the harness finds each by its name."""

from __future__ import annotations

import json
import os
import shutil

from conftest import ROOT, SMALL

from benchmark import run
from benchmark.paths import Bench


def _copy_checkout(tmp_path) -> str:
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    return str(root)


def test_new_config_mix_and_metric_are_found_by_name(tmp_path):
    root = _copy_checkout(tmp_path)
    b = os.path.join(root, "benchmark")
    # a new configuration: its file and its generator, by name
    cfg = json.load(open(os.path.join(b, "configs", "horse31k.json")))
    cfg["name"] = "terrain_small"
    cfg["scene"].update(SMALL["horse31k"])
    json.dump(cfg, open(os.path.join(b, "configs", "terrain_small.json"), "w"))
    shutil.copy(os.path.join(b, "scenes", "horse31k.py"),
                os.path.join(b, "scenes", "terrain_small.py"))
    # a new mix: parameters only, for the existing frame driver
    mix = json.load(open(os.path.join(b, "traffic", "frame-ssaa2.json")))
    mix.update(ssaa=1, warmup_frames=1, check_frames=1, check_tiles=2,
               trace_after=0.0, trace_frames=2)
    json.dump(mix, open(os.path.join(b, "traffic", "frame-ssaa1.json"), "w"))
    # a new per-layer metric: a reader of its own
    with open(os.path.join(b, "metrics", "frames.traced.py"), "w") as f:
        f.write("def read(trace):\n    return trace.units('frame') or None\n")
    json.dump({"px_off_share": 0.01, "mean_abs_lsb": 0.1},
              open(os.path.join(b, "limits", "terrain_small.frame-ssaa1.json"),
                   "w"))
    spec = json.load(open(os.path.join(root, "BENCHMARK.json")))
    name = "terrain_small.frame-ssaa1"
    spec["configs"].append({"name": "terrain_small", "source": "test",
                            "file": "benchmark/configs/terrain_small.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": name, "config": "terrain_small",
                              "traffic": "frame-ssaa1", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] == "mrays_per_s":
            m["workloads"].append(name)
    spec["per_layer"].append({"name": "frames.traced", "unit": "frames",
                              "better": "higher", "source": "program_span",
                              "layer": "programs", "moves": "mrays_per_s",
                              "workloads": [name]})
    json.dump(spec, open(os.path.join(root, "BENCHMARK.json"), "w"))

    bench = Bench(root)
    assert bench.config("terrain_small")["scene"]["cells"] == 12
    assert bench.traffic("frame-ssaa1")["ssaa"] == 1
    assert "frames.traced" in [m["name"] for m in bench.metrics(name, True)]
    assert [m["name"] for m in bench.metrics(name, False)] == [
        "setup_s", "mrays_per_s", "peak_mem_gib"]
    line = run.run(name, 7, 0.5, True, bench, device="cpu",
                   work_dir=str(tmp_path / "work"))
    assert line["correct"], line
    assert line["metrics"]["frames.traced"]["value"] == 2
    line = run.run(name, 7, 0.5, False, bench, device="cpu",
                   work_dir=str(tmp_path / "work"))
    assert set(line["metrics"]) == {"setup_s", "mrays_per_s", "peak_mem_gib"}


def test_every_cell_names_files_that_exist(bench):
    for w in bench.spec["workloads"]:
        cfg = bench.config(w["config"])
        assert cfg["name"] == w["config"]
        tr = bench.traffic(w["traffic"])
        bench.load_module("drivers", tr["driver"])
        bench.load_module("scenes", w["config"])
        assert bench.limits(w["name"])
        assert bench.metrics(w["name"], False)
        for m in bench.metrics(w["name"], True):
            assert callable(bench.reader(m["name"]))
