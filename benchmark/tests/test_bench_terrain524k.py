"""The big-scene configuration ``terrain524k``: its generator frozen at
the counts the configuration states, deterministic per seed, loaded by
the port from its XML as its users load it, and its cell run end to end
at a small size on the CPU and, on a machine with a CUDA card (``python
-m pytest benchmark/tests -m gpu``), once at its size through the command
line."""

from __future__ import annotations

import copy
import json
import subprocess
import sys

import numpy as np
import pytest

from benchmark import run, sceneio
from conftest import ROOT

SMALL = dict(cells=24, width=32, height=32)


def _small(bench) -> dict:
    cfg = copy.deepcopy(bench.config("terrain524k"))
    cfg["scene"].update(SMALL)
    return cfg


def test_terrain524k_counts_and_determinism(bench):
    cfg = bench.config("terrain524k")
    a = sceneio.generate(bench, cfg, 2**31 + 3)
    b = sceneio.generate(bench, cfg, 2**31 + 3)
    c = sceneio.generate(bench, cfg, 5)
    assert a["vertices"] == b["vertices"]
    assert a["vertices"] != c["vertices"]
    assert sum(len(f) for _, f in a["meshes"]) == cfg["triangles"] == 524_288
    assert len(a["meshes"]) == cfg["meshes"] == 2
    assert not a["spheres"] and cfg["spheres"] == 0
    assert len(a["materials"]) == cfg["materials"] == 2
    mirrors = [i + 1 for i, m in enumerate(a["materials"]) if m["is_mirror"]]
    assert mirrors == [2] and cfg["mirror_materials"] == 1
    assert sorted(m for m, _ in a["meshes"]) == [1, 2]
    assert len(a["point_lights"]) == cfg["lights"] == 2
    assert a["max_depth"] == 2 and not a["triangles"]
    assert [(k["width"], k["height"]) for k in a["cameras"]] == [(1024, 1024)]
    assert cfg["reduced"] == []
    for key in ("triangles", "meshes", "spheres", "materials",
                "mirror_materials", "lights", "width", "height", "max_depth",
                "ssaa"):
        assert cfg[key] == cfg["published"][key], key


def test_terrain524k_xml_round_trip_through_the_port(bench, tmp_path):
    from raytracer_tpu_torch.models.scene import load_scene
    from raytracer_tpu_torch.utils.xml_ingest import parse_xml

    parsed = sceneio.generate(bench, _small(bench), 4)
    path = str(tmp_path / "terrain524k.xml")
    sceneio.write_xml(parsed, path)
    back = parse_xml(path)
    assert np.array_equal(np.float32(back["vertices"]).ravel(),
                          np.float32(parsed["vertices"]).ravel())
    assert [tuple(map(tuple, f)) for _, f in back["meshes"]] == [
        tuple(map(tuple, np.asarray(f))) for _, f in parsed["meshes"]]
    assert [m for m, _ in back["meshes"]] == [2, 1]
    assert not back["spheres"] and len(back["cameras"]) == 1
    _, meta = load_scene(path, device="cpu")
    assert meta.n_tris == 2 * 24 * 24 and meta.n_lights == 2


def test_terrain524k_cell_runs_correct_on_cpu(bench, tmp_path):
    tr = copy.deepcopy(bench.traffic("frame-ssaa2"))
    tr.update(warmup_frames=1, check_tiles=3, check_frames=2)
    line = run.run("terrain524k.frame-ssaa2", 2**31 + 11, 0.5, False, bench,
                   device="cpu", config=_small(bench), traffic=tr,
                   work_dir=str(tmp_path))
    assert line["correct"], line
    assert set(line["metrics"]) == {"setup_s", "mrays_per_s", "peak_mem_gib"}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark runs on one")


@pytest.mark.gpu
def test_terrain524k_short_run_on_the_card(card, bench):
    workload = "terrain524k.frame-ssaa2"
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", str(2**31 + 97), "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"], line
    assert line["device"]["platform"] == "gpu"
    names = {m["name"] for m in bench.metrics(workload, False)}
    assert set(line["metrics"]) == names
