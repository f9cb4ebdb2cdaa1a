"""The readers of the port's own spans and counters
(``benchmark/port_spans.py``) on a made-up stretch and a made-up record,
with answers worked out by hand: idle split among nested spans, idle
outside every span left out, spans and samples outside the stretch
ignored, None without frames, device work, spans or the recorder; and
the set-up readers on a traced CPU run of each cell."""

from __future__ import annotations

import random
import types
from typing import NamedTuple

import pytest
import torch  # noqa: F401 (loaded, as in a run, before any span)
from conftest import run_small

from benchmark import harness, port_spans

FRAME = ["programs.idle_ms.render", "pipeline.idle_ms.render",
         "programs.flag_reads.render", "kernels.lane_use.render"]
SETUP = ["backend.load_s.setup", "scene.ingest_s.setup",
         "accel.build_s.setup", "programs.warmup_s.setup"]


class Span(NamedTuple):
    id: int
    parent: int
    name: str
    what: object
    start: int
    end: int
    tid: int = 1


class Sample(NamedTuple):
    name: str
    t: int
    value: float


def _trace(device, units=("bench.frame",) * 2):
    """A stretch [0, 200] of two units, 100 ns each."""
    spans = [(u, 100 * i, 100 * (i + 1)) for i, u in enumerate(units)]
    return harness.Trace(list(device), [], spans, ["closest_kernel"], {})


# busy [0,20] [30,60] [70,150] [160,190]: idle [20,30] [60,70] [150,160]
# [190,200], 40 ns
DEVICE = [("void closest_kernel<true>()", 0, 20), ("sort", 30, 60),
          ("gather", 70, 150), ("copy", 160, 190)]
SPANS = [
    Span(9, 0, "program.first", "bounce 0", -50, -40),      # set-up
    Span(1, 0, "pipeline.frame", "parity", 0, 98),
    Span(2, 1, "pipeline.band", 0, 2, 80),
    Span(3, 2, "program.step", "bounce 0", 5, 25),          # idle 20-25
    Span(4, 2, "program.flags", "", 25, 28),                # idle 25-28
    Span(5, 2, "program.step", "bounce 1", 62, 65),         # idle 62-65
    Span(6, 0, "pipeline.frame", "parity", 100, 198),
    Span(7, 6, "program.flags", "", 120, 125),              # busy
    Span(8, 6, "pipeline.to_host", "", 148, 158),           # idle 150-158
    Span(10, 0, "program.flags", "", 210, 215),             # after
]
SAMPLES = [Sample("wave.active", 10, 1000), Sample("wave.lanes", 10, 1280),
           Sample("wave.active", 50, 300), Sample("wave.lanes", 50, 640),
           Sample("wave.active", 250, 5), Sample("wave.lanes", 250, 1000)]
TOTALS = {"backend.load": 0.5, "scene.ingest": 0.25, "accel.build": 1.5,
          "program.make": 0.125, "program.first": 2.0,
          "program.capture": 0.375}


@pytest.fixture
def recorded(monkeypatch):
    """Install a made-up recorder; returns it (edit it in place)."""
    rec = types.SimpleNamespace(spans=list(SPANS), samples=list(SAMPLES),
                                totals=dict(TOTALS))
    monkeypatch.setattr(port_spans, "record", lambda: rec)
    return rec


def _read(bench, name, trace):
    return bench.reader(name)(trace)


def test_idle_split_among_the_innermost_spans(bench, recorded):
    t = _trace(DEVICE)
    # programs: 20-25 (step), 25-28 (flags), 62-65 (step) = 11 ns;
    # pipeline: 28-30, 60-62 and 65-70 (band), 150-158 (to_host), 158-160
    # and 190-198 (frame) = 27 ns; the caller's: 198-200
    by = port_spans.idle_ns_by_layer(t, recorded.spans)
    assert by == {"program": 11, "pipeline": 27, None: 2}
    assert sum(by.values()) == pytest.approx(
        harness.idle_share(t) / 100 * 200)
    assert _read(bench, "programs.idle_ms.render", t) == pytest.approx(
        11 / 1e6 / 2)
    assert _read(bench, "pipeline.idle_ms.render", t) == pytest.approx(
        27 / 1e6 / 2)


def test_flag_reads_and_lane_use_count_the_stretch_only(bench, recorded):
    t = _trace(DEVICE)
    assert _read(bench, "programs.flag_reads.render", t) == 1.0   # 2 / 2
    assert _read(bench, "kernels.lane_use.render", t) == pytest.approx(
        100 * 1300 / 1920)


def test_setup_readers_read_the_totals(bench, recorded):
    t = _trace(DEVICE)
    got = [_read(bench, n, t) for n in SETUP]
    assert got == [0.5, 0.25, 1.5, 2.5]
    recorded.totals.pop("accel.build")              # brute: nothing built
    assert _read(bench, "accel.build_s.setup", t) == 0.0


def test_none_without_frames_device_work_spans_or_recorder(
        bench, recorded, monkeypatch):
    steps = _trace(DEVICE, units=("bench.step",) * 2)
    idle = _trace([])
    for name in FRAME:
        assert _read(bench, name, steps) is None, name
        assert _read(bench, name, idle) is None, name
    recorded.spans[:] = [s for s in SPANS if not 0 <= s.start < 200]
    for name in FRAME[:3]:
        assert _read(bench, name, _trace(DEVICE)) is None, name
    recorded.samples[:] = [c for c in SAMPLES if c.name == "wave.active"]
    assert _read(bench, "kernels.lane_use.render", _trace(DEVICE)) is None
    monkeypatch.setattr(port_spans, "record", lambda: None)
    for name in FRAME + SETUP:                      # a parent without it
        assert _read(bench, name, _trace(DEVICE)) is None, name


def _nested(rng, a, b, depth, ids, parent=0):
    spans, t = [], a
    while depth and t < b - 2 and rng.random() < 0.7:
        s = rng.randrange(t, b - 1)
        e = rng.randrange(s + 1, b)
        i = next(ids)
        name = rng.choice(["pipeline.band", "program.step", "program.flags"])
        spans.append(Span(i, parent, name, "", s, e))
        spans += _nested(rng, s, e, depth - 1, ids, i)
        t = e
    return spans


@pytest.mark.parametrize("seed", range(8))
def test_idle_split_equals_a_count_ns_by_ns(seed):
    """Random nested spans and device intervals against a brute force:
    each idle ns goes to the layer of the latest-starting span open."""
    import itertools

    rng = random.Random(seed)
    spans = _nested(rng, -10, 210, 4, itertools.count(1))
    device = []
    for _ in range(rng.randrange(1, 12)):
        s = rng.randrange(-20, 200)
        device.append(("k", s, s + rng.randrange(1, 40)))
    t = _trace(device)
    want = {}
    for x in range(0, 200):
        if any(s <= x < e for _, s, e in device):
            continue
        open_ = [s for s in spans if s.start <= x < s.end]
        inner = max(open_, key=lambda s: (s.start, -s.end), default=None)
        layer = inner.name.split(".")[0] if inner else None
        want[layer] = want.get(layer, 0) + 1
    assert port_spans.idle_ns_by_layer(t, spans) == want


@pytest.mark.parametrize("workload", ["horse31k.frame-ssaa2",
                                      "horse31k.train-1m"])
def test_a_traced_cpu_run_reports_the_setup_layers(bench, tmp_path,
                                                   workload):
    """On the CPU the programs run eagerly and no kernel library loads;
    scene ingest and the accelerator are timed, and the frame readers
    read nothing (no device work)."""
    line = run_small(bench, workload, tmp_path, trace=True)
    m = line["metrics"]
    assert set(SETUP) <= set(m), m
    assert m["scene.ingest_s.setup"]["value"] > 0
    assert m["accel.build_s.setup"]["value"] > 0
    assert m["backend.load_s.setup"]["value"] == 0
    assert m["programs.warmup_s.setup"]["value"] == 0
    assert not set(FRAME) & set(m)
