"""The port's spans and counters (``raytracer_tpu_torch.tracing``) on the
CPU: nothing on the hot path without a profiler while the set-up totals
still add up; with one, the spans' nesting, their stamps against the
profiler's own host events, the wavefront's counters against counts made
from its carry, and ``render.py --profile``'s merged trace."""

from __future__ import annotations

import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_port_util import (  # noqa: F401 (stub_graphs: a fixture)
    ENTRY_XML, epilogue_calls, port_scene, stub_graphs,
)

HOT = ("pipeline.", "program.step", "program.flags")


@pytest.fixture
def tracing():
    from raytracer_tpu_torch import tracing

    tracing.clear()
    yield tracing
    tracing.clear()


def _entry():
    from raytracer_tpu_torch.models.scene import load_scene
    from raytracer_tpu_torch.render import engine_accel

    data, meta = load_scene(ENTRY_XML, device="cpu")
    return data, meta, engine_accel("auto", None, data, meta, "cpu")


def _frame(data, meta, accel):
    from raytracer_tpu_torch.pipeline import render_one_camera

    return render_one_camera(data, meta, meta.cameras[0], accel, ssaa=2,
                             device="cpu")[0]


def _host_events(prof) -> list:
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def test_off_records_no_hot_span_and_keeps_the_setup_totals(
        tracing, stub_graphs):
    from raytracer_tpu_torch import backend

    assert not tracing.recording()
    assert tracing.span("pipeline.frame") is tracing.span("program.flags")
    data, meta, accel = _entry()
    _frame(data, meta, accel)
    _frame(data, meta, accel)               # the replays
    names = {s.name for s in tracing.spans}
    assert not [n for n in names if n.startswith(HOT)]
    assert not tracing.samples
    assert names == {"scene.ingest", "accel.build", "program.make",
                     "program.first", "program.capture"}
    for name in names:
        assert tracing.totals[name] > 0, name
    assert backend.build_seconds() == tracing.seconds("backend.load") == 0.0
    # the frame program's construction holds its wavefront's: self times
    made = [s for s in tracing.spans if s.name == "program.make"]
    assert {s.what for s in made} == {"frame band", "rays cluster"}
    outer = next(s for s in made if s.what == "frame band")
    inner = next(s for s in made if s.what == "rays cluster")
    assert inner.parent == outer.id
    assert tracing.totals["program.make"] == pytest.approx(
        (outer.end - outer.start) / 1e9, abs=1e-7)


def test_setup_totals_are_self_seconds(tracing):
    with tracing.setup_span("accel.build"):
        time.sleep(0.002)
        with tracing.setup_span("backend.load"):
            time.sleep(0.003)
    outer, inner = sorted(tracing.spans, key=lambda s: s.start)
    assert inner.parent == outer.id and outer.parent == 0
    assert tracing.totals["backend.load"] == pytest.approx(
        (inner.end - inner.start) / 1e9)
    assert tracing.totals["accel.build"] == pytest.approx(
        (outer.end - outer.start - (inner.end - inner.start)) / 1e9)
    assert tracing.totals["accel.build"] >= 0.002
    assert tracing.seconds("accel.build", "backend.load") == pytest.approx(
        (outer.end - outer.start) / 1e9)


def test_spans_nest_and_enclose_the_profilers_events(tracing, stub_graphs):
    data, meta, accel = _entry()
    want = _frame(data, meta, accel)
    tracing.clear()
    reads = stub_graphs.stats["flag_reads"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = _frame(data, meta, accel)
    assert torch.equal(torch.from_numpy(got), torch.from_numpy(want))
    spans = list(tracing.spans)
    by_id = {s.id: s for s in spans}
    frame, = [s for s in spans if s.name == "pipeline.frame"]
    assert frame.parent == 0 and frame.what == "parity"
    kids = [s.name for s in sorted(spans, key=lambda s: s.start)
            if s.parent == frame.id]
    assert kids == ["pipeline.upload", "pipeline.band", "pipeline.assemble",
                    "pipeline.assemble", "pipeline.to_host"]
    band, = [s for s in spans if s.name == "pipeline.band"]
    assert band.what == 0
    steps = sorted((s for s in spans if s.name.startswith("program.")),
                   key=lambda s: s.start)
    assert all(by_id[s.parent] is band for s in steps)
    replays = [s.what for s in steps if s.name == "program.step"]
    assert replays[0] == "band prologue" and replays[-1] == "band epilogue"
    assert replays[1:-1] == [f"bounce {d}" for d in range(len(replays) - 2)]
    flags = [s for s in steps if s.name == "program.flags"]
    assert len(flags) == stub_graphs.stats["flag_reads"] - reads >= 1
    for s in spans:                         # children inside their parents
        if s.parent:
            p = by_id[s.parent]
            assert p.start <= s.start <= s.end <= p.end, (s, p)
    host = [h for h in _host_events(prof) if h[0].startswith("aten::")]
    # the stamps share the profiler's clock: every op of the frame lies in
    # its span, each flag read's host copy in its flag span, the bands'
    # cat in an assembly span
    assert all(frame.start <= a and b <= frame.end for _, a, b in host)
    for f in flags:
        assert [h for h in host if f.start <= h[1] and h[2] <= f.end], f
    cats = [h for h in host if h[0] == "aten::cat" and not (
        band.start <= h[1] and h[2] <= band.end)]
    assert cats and all(
        any(s.name == "pipeline.assemble" and s.start <= a and b <= s.end
            for s in spans) for _, a, b in cats)
    to_host, = [s for s in spans if s.name == "pipeline.to_host"]
    assert [h for h in host if h[0] == "aten::to"
            and to_host.start <= h[1] and h[2] <= to_host.end]


@pytest.mark.parametrize("shared", [True, False])
def test_wave_samples_equal_counts_from_the_carry(tracing, monkeypatch,
                                                  shared):
    """A terrain at max depth 3 whose mirror wave compacts: each bounce's
    ``wave.active`` and ``wave.lanes`` against the active mask of the
    carry the bounce traces (after a compaction's sort)."""
    from raytracer_tpu_torch.models import whitted
    from raytracer_tpu_torch.models.bvh import build_bvh
    from raytracer_tpu_torch.models.clusters import build_clusters
    from raytracer_tpu_torch.ops.camera import camera_vectors, eye_rays_from
    from raytracer_tpu_torch.ops.kernels import TILE

    data, meta = port_scene("terrain16d3")
    cs = build_clusters(data, meta, build_bvh(data, meta))
    cam = meta.cameras[0]
    origin, dirs = eye_rays_from(torch.from_numpy(camera_vectors(cam)),
                                 cam.width, cam.height)
    blocks, perm, _ = whitted._tile_order(cam.height, cam.width, "cpu")
    dirs = whitted.apply_tile_order(dirs, cam.height, cam.width, blocks,
                                    perm).contiguous()
    if not shared:
        origin = origin.expand(dirs.shape[0], 3).contiguous()
    seen, compacted = [], []
    bounce, compact = whitted._fused_bounce, whitted._compact_carry

    def spy(data, meta, accel, bfc, fns, carry, *a):
        act = carry[3]
        seen.append((int(act.sum()),
                     TILE * int(act.reshape(-1, TILE).any(1).sum())))
        return bounce(data, meta, accel, bfc, fns, carry, *a)

    monkeypatch.setattr(whitted, "_fused_bounce", spy)
    monkeypatch.setattr(whitted, "_compact_carry",
                        lambda c: compacted.append(c[0]) or compact(c))
    want = whitted.render_rays(data, meta, origin, dirs, cs)
    assert not tracing.samples and compacted, "the gate was never taken"
    seen.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        got = whitted.render_rays(data, meta, origin, dirs, cs)
    assert torch.equal(got, want)
    active = [s.value for s in tracing.samples if s.name == "wave.active"]
    lanes = [s.value for s in tracing.samples if s.name == "wave.lanes"]
    assert list(zip(active, lanes)) == seen
    assert seen[0] == (dirs.shape[0], dirs.shape[0])
    assert len(seen) >= 3 and lanes[2] < dirs.shape[0]


def test_brute_engine_samples_active_rays_only(tracing):
    from raytracer_tpu_torch.models import whitted
    from raytracer_tpu_torch.models.scene import load_scene
    from raytracer_tpu_torch.ops.camera import camera_vectors, eye_rays_from

    data, meta = load_scene(ENTRY_XML, device="cpu")
    cam = meta.cameras[0]
    origin, dirs = eye_rays_from(torch.from_numpy(camera_vectors(cam)),
                                 cam.width, cam.height)
    with profile(activities=[ProfilerActivity.CPU]):
        whitted.render_rays(data, meta, origin, dirs, None, engine="brute")
    names = [s.name for s in tracing.samples]
    assert names and set(names) == {"wave.active"}
    assert tracing.samples[0].value == dirs.shape[0]


@pytest.mark.parametrize("engine", ["cluster", "brute", "bvh"])
def test_wave_fused_sampled_on_each_cluster_forward_bounce(tracing, engine):
    """``wave.fused`` (rays active entering a bounce whose epilogue ran
    through ``cluster_trace.hit_record`` and ``cluster_trace.shade_bounce``)
    after each ``wave.active`` of the cluster engine's bounces, equal to
    it; the brute and BVH engines sample none."""
    from raytracer_tpu_torch.models import whitted
    from raytracer_tpu_torch.ops import kernels as K
    from raytracer_tpu_torch.ops.camera import camera_vectors, eye_rays_from
    from raytracer_tpu_torch.render import engine_accel

    data, meta = port_scene("terrain16d3")
    accel = engine_accel(engine, None, data, meta, "cpu")
    cam = meta.cameras[0]
    origin, dirs = eye_rays_from(torch.from_numpy(camera_vectors(cam)),
                                 cam.width, cam.height)
    with profile(activities=[ProfilerActivity.CPU]), epilogue_calls() as calls:
        whitted.render_rays(data, meta, origin, dirs, accel, engine=engine)
    fused = [s.value for s in tracing.samples if s.name == "wave.fused"]
    active = [s.value for s in tracing.samples if s.name == "wave.active"]
    shaded = sum(c.name == "shade_bounce" for c in calls)
    assert len(active) >= 2
    if engine == "cluster":
        assert fused == active and shaded == len(active)
    else:
        assert fused == [] and shaded == 0
    assert K.launches["shade_bounce"] == 0


def test_render_cli_profile_merges_spans_and_counters(tracing, tmp_path):
    from raytracer_tpu_torch import render

    out = tmp_path / "prof"
    render.main([ENTRY_XML, "--device", "cpu", "--ssaa", "1",
                 "--out-dir", str(tmp_path), "--profile", str(out)])
    trace = json.loads((out / "trace_rank0.json").read_text())
    events = trace["traceEvents"]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    port = [e for e in events if e.get("cat") == "port"]
    spans = [e for e in port if e["ph"] == "X"]
    names = {e["name"] for e in spans}
    assert ops and {"pipeline.frame", "pipeline.band", "pipeline.assemble",
                    "pipeline.to_host", "pipeline.write",
                    "program.flags"} <= names
    counters = {e["name"] for e in port if e["ph"] == "C"}
    assert counters == {"wave.active", "wave.lanes", "wave.fused"}
    # on the main thread's row, on the kineto events' time base
    assert {e["tid"] for e in spans} <= {e["tid"] for e in ops}
    def inside(op, name):
        return any(s["name"] == name and s["ts"] <= op["ts"]
                   and op["ts"] + op["dur"] <= s["ts"] + s["dur"]
                   for s in spans)

    cats = [e for e in ops if e["name"] == "aten::cat"
            and not inside(e, "pipeline.band")]
    assert cats and all(inside(e, "pipeline.assemble") for e in cats)
