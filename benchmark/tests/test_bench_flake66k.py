"""The sphereflake configuration ``flake66k``: its file names the SPD
source, the size factor and what it assumes; its generator reproduces
the published counts and view, deterministic per seed; the port loads it
from its XML as its users load it; its cell runs end to end at a small
size on the CPU and, on a machine with a CUDA card (``python -m pytest
benchmark/tests -m gpu``), once at its size through the command line."""

from __future__ import annotations

import copy
import json
import subprocess
import sys

import numpy as np
import pytest

from benchmark import run, sceneio
from conftest import ROOT

WORKLOAD = "flake66k.frame-ssaa2"
# 820 spheres in 7 clusters (dense sphere rows), 32x32
SMALL = dict(size_factor=3, width=32, height=32)


def _small(bench) -> dict:
    cfg = copy.deepcopy(bench.config("flake66k"))
    cfg["scene"].update(SMALL)
    return cfg


def test_flake66k_file_and_counts(bench):
    cfg = bench.config("flake66k")
    spec = [c for c in bench.spec["configs"] if c["name"] == "flake66k"][0]
    assert spec["reduced"] == cfg["reduced"] == []
    assert spec["source"] == cfg["source"]
    assert "balls.c" in cfg["source"] and "size factor 5" in cfg["source"]
    assert len(cfg["assumed"]) == 7
    pub = cfg["published"]
    assert (pub["size_factor"], pub["spheres"], pub["children"],
            pub["lights"], pub["width"], pub["height"]) == (5, 66430, 9, 3,
                                                            512, 512)
    assert pub["spheres"] == sum(9**i for i in range(pub["size_factor"] + 1))
    assert pub["child_radius_ratio"] == 1 / 3
    for key, value in pub.items():
        if key != "scene":
            assert cfg[key] == value, key
    a = sceneio.generate(bench, cfg, 2**31 + 3)
    b = sceneio.generate(bench, cfg, 2**31 + 3)
    c = sceneio.generate(bench, cfg, 5)
    assert a["vertices"] == b["vertices"] and a["spheres"] == b["spheres"]
    assert a["vertices"] != c["vertices"]
    assert a["vertices"][:12] == c["vertices"][:12]      # the ground
    assert len(a["spheres"]) == 66_430
    assert len(a["point_lights"]) == 3 and a["max_depth"] == 6
    assert [(k["width"], k["height"]) for k in a["cameras"]] == [(512, 512)]
    assert sum(m["is_mirror"] for m in a["materials"]) == cfg["mirror_materials"]


def test_flake66k_xml_round_trip_through_the_port(bench, tmp_path):
    from raytracer_tpu_torch.models.scene import load_scene
    from raytracer_tpu_torch.utils.xml_ingest import parse_xml

    parsed = sceneio.generate(bench, _small(bench), 4)
    path = str(tmp_path / "flake66k.xml")
    sceneio.write_xml(parsed, path)
    back = parse_xml(path)
    assert np.array_equal(np.float32(back["vertices"]).ravel(),
                          np.float32(parsed["vertices"]).ravel())
    assert back["spheres"] == parsed["spheres"]
    assert [tuple(map(tuple, f)) for _, f in back["meshes"]] == [
        tuple(map(tuple, np.asarray(f))) for _, f in parsed["meshes"]]
    assert len(back["cameras"]) == 1
    _, meta = load_scene(path, device="cpu")
    assert (meta.n_spheres, meta.n_tris, meta.n_lights) == (820, 2, 3)


def test_flake66k_cell_runs_correct_on_cpu(bench, tmp_path):
    tr = copy.deepcopy(bench.traffic("frame-ssaa2"))
    tr.update(warmup_frames=1, check_tiles=2, check_frames=1)
    line = run.run(WORKLOAD, 2**31 + 11, 0.5, False, bench, device="cpu",
                   config=_small(bench), traffic=tr, work_dir=str(tmp_path))
    assert line["correct"], line
    assert set(line["metrics"]) == {"setup_s", "mrays_per_s", "peak_mem_gib"}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark runs on one")


@pytest.mark.gpu
def test_flake66k_short_run_on_the_card(card, bench):
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", WORKLOAD,
         "--seed", str(2**31 + 97), "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"], line
    assert line["device"]["platform"] == "gpu"
    names = {m["name"] for m in bench.metrics(WORKLOAD, False)}
    assert set(line["metrics"]) == names
