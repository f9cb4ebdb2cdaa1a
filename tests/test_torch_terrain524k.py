"""The big-scene configuration ``terrain524k`` (``benchmark/scenes``) and
the port's route through it, on the CPU: the generator at its published
counts; a small terrain of the same generator through the hierarchical
mask, the any-hit shadows and capped bands (the budgets that pick them
lowered), from its XML through ``load_scene`` and ``render_one_camera``,
against the plain reference under the cell's limits; the wavefront's
``mask.tiles`` / ``mask.chunks`` samples and the two readers of the
cell's per-layer metrics."""

from __future__ import annotations

import copy
import os
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness, imagecheck, port_spans, sceneio
from benchmark.drivers.frame import camera_at, port_camera
from benchmark.paths import Bench
from benchmark.reference import whitted as ref
from torch_port_util import stub_graphs  # noqa: F401 (a fixture)

CONFIG = "terrain524k"
CELL = "terrain524k.frame-ssaa2"
# 144 clusters (2 superclusters, the second partial), 32x32
SMALL = dict(cells=96, width=32, height=32)


@pytest.fixture(scope="module")
def bench():
    return Bench()


@pytest.fixture
def tracing():
    from raytracer_tpu_torch import tracing

    tracing.clear()
    yield tracing
    tracing.clear()


def _small(bench) -> dict:
    cfg = copy.deepcopy(bench.config(CONFIG))
    cfg["scene"].update(SMALL)
    return cfg


def test_generator_counts_and_seeds(bench):
    """(a) At its configuration: 524,288 triangles in 2 meshes, 2
    materials (1 mirror, on every 7th row of cells), 2 lights, phase 3b's
    camera; the same scene for a seed, other noise for another."""
    cfg = bench.config(CONFIG)
    a = sceneio.generate(bench, cfg, 2**31 + 7)
    b = sceneio.generate(bench, cfg, 2**31 + 7)
    c = sceneio.generate(bench, cfg, 8)
    va, vc = (np.asarray(x["vertices"]).reshape(-1, 3) for x in (a, c))
    assert np.array_equal(va, np.asarray(b["vertices"]).reshape(-1, 3))
    assert np.array_equal(va[:, [0, 2]], vc[:, [0, 2]])
    assert not np.array_equal(va[:, 1], vc[:, 1])
    assert len(va) == 513 * 513
    counts = [len(f) for _, f in a["meshes"]]
    assert sum(counts) == cfg["triangles"] == 524_288
    assert len(a["meshes"]) == cfg["meshes"] == 2
    # the mirror stripes: 74 of the 512 rows of cells (0, 7, ..., 511)
    assert [m for m, _ in a["meshes"]] == [2, 1] and counts[0] == 74 * 1024
    assert all(np.array_equal(x, y) for (_, x), (_, y) in zip(a["meshes"],
                                                               b["meshes"]))
    assert len(a["materials"]) == cfg["materials"] == 2
    assert [m["is_mirror"] for m in a["materials"]] == [False, True]
    assert len(a["point_lights"]) == cfg["lights"] == 2
    assert not a["spheres"] and not a["triangles"]
    assert a["max_depth"] == cfg["max_depth"] == 2
    cam = a["cameras"][0]
    assert (cam["width"], cam["height"]) == (1024, 1024)
    assert cam["position"] == [0.0, 35.0, 75.0]
    assert cfg["reduced"] == []
    for key in ("triangles", "meshes", "materials", "mirror_materials",
                "lights", "width", "height", "max_depth", "ssaa"):
        assert cfg[key] == cfg["published"][key], key


def test_big_scene_route_matches_the_reference(bench, tmp_path, tracing,
                                               stub_graphs, monkeypatch):
    """(b) A small terrain of the generator from its XML through
    ``load_scene`` and ``render_one_camera`` (SSAA 2 parity, programs on
    stub graphs, as the cell's frames replay them), with the budgets
    lowered so that it takes the big scene's route: every exact mask
    hierarchical, every shadow ray on the any-hit kernel, bands capped at
    1,024 rays (4 a frame).  The frames' tiles against the plain
    reference under the cell's own limits."""
    from raytracer_tpu_torch.models import whitted
    from raytracer_tpu_torch.models.scene import load_scene
    from raytracer_tpu_torch.ops import cluster_trace as ctr
    from raytracer_tpu_torch.ops import kernels as K
    from raytracer_tpu_torch.pipeline import render_one_camera
    from raytracer_tpu_torch.render import engine_accel

    cfg = _small(bench)
    seed = 2**31 + 19
    parsed = sceneio.generate(bench, cfg, seed)
    xml = str(tmp_path / "scene.xml")
    sceneio.write_xml(parsed, xml)
    data, meta = load_scene(xml, device="cpu")
    accel = engine_accel("auto", None, data, meta, "cpu")
    assert accel.tri_cmin.shape[0] == 144
    monkeypatch.setattr(ctr, "SUPER_MIN_CPAD", 128)
    monkeypatch.setattr(ctr, "SHADOW_PLANES_BYTES_MAX", 0)
    monkeypatch.setattr(whitted, "SEG_SLOTS", 0)
    monkeypatch.setattr(whitted, "_BIG_SCENE_CHUNK", 1024)
    calls = {"ray_mask_hier": 0, "any_hit": 0, "shadow": 0}

    def spy(name):
        f = getattr(K, name)

        def counted(*a, **k):
            calls[name] += 1
            return f(*a, **k)
        monkeypatch.setattr(K, name, counted)

    for name in calls:
        spy(name)
    tr = bench.traffic("frame-ssaa2")
    cam0 = parsed["cameras"][0]
    frames = [12, 36]

    def frame(k):
        cam = port_camera(camera_at(cam0, k, tr))
        return render_one_camera(data, meta, cam, accel, ssaa=tr["ssaa"],
                                 ssaa_mode=tr["ssaa_mode"], chunk=tr["chunk"],
                                 engine=tr["engine"], device="cpu")[0]

    images = [frame(frames[0])]
    with profile(activities=[ProfilerActivity.CPU]):
        images.append(frame(frames[1]))
    assert calls["ray_mask_hier"] > 0 and calls["any_hit"] > 0
    assert calls["shadow"] == 0
    bands = [s for s in tracing.spans if s.name == "pipeline.band"]
    assert [s.what for s in bands] == list(range(0, 64, 16))
    sums = {n: sum(s.value for s in tracing.samples if s.name == n)
            for n in ("mask.tiles", "mask.chunks")}
    assert 0 < sums["mask.tiles"] <= sums["mask.chunks"] <= 2 * sums["mask.tiles"]

    limits = bench.limits(CELL)
    rng = np.random.default_rng(seed)
    scene = ref.Scene(parsed, "cpu")
    tally = imagecheck.Tally()
    for k, image in zip(frames, images):
        tiles = imagecheck.sample_tiles(rng, 32, 32, 4)
        got = ref.tiles_image(scene, camera_at(cam0, k, tr),
                              tr["ssaa"], tiles, imagecheck.TILE).numpy()
        tally.add(got, image, tiles)
    ctx = types.SimpleNamespace(checks=[])
    ctx.check = lambda name, value: ctx.checks.append(
        harness.Check(name, value, limits[name]))
    tally.report(ctx)
    assert tally.pixels == 2 * 4 * 16 * 16
    assert all(c.ok for c in ctx.checks), ctx.checks


def _wavefront(bench):
    """An eager cluster wavefront over a small terrain's eye rays, its
    masks hierarchical and its shadows any-hit (the budgets lowered by
    the caller)."""
    from raytracer_tpu_torch.models import programs, whitted
    from raytracer_tpu_torch.models.scene import from_parsed
    from raytracer_tpu_torch.ops.camera import camera_vectors, eye_rays_from
    from raytracer_tpu_torch.render import engine_accel

    parsed = sceneio.generate(bench, _small(bench), 5)
    data, meta = from_parsed(parsed, "cpu")
    accel = engine_accel("auto", None, data, meta, "cpu")
    cam = meta.cameras[0]
    origin, dirs = eye_rays_from(torch.from_numpy(camera_vectors(cam)),
                                 cam.width, cam.height)
    blocks, perm, _ = whitted._tile_order(cam.height, cam.width, "cpu")
    dirs = whitted.apply_tile_order(dirs, cam.height, cam.width, blocks,
                                    perm).contiguous()
    wf = whitted._wavefront(programs.EAGER, data, meta, accel, dirs.shape[0],
                            True, False, False, "auto", "cpu")
    wf.load(origin, dirs)
    return wf


def test_mask_samples_count_each_bounce_once(bench, tracing, monkeypatch):
    """(c) ``mask.tiles`` and ``mask.chunks``, from the flags the host
    reads between bounces, against the active tiles and the coarse bits
    of every ``ray_mask_hier`` call, bounce by bounce: none without a
    profiler; with one, what the running sums grew by between reads, so a
    run's last bounce shows at the next sampled run's first read and the
    first read after an unsampled run sets the base only.  A scene whose
    masks are flat keeps three flags and samples neither (the flake's
    tests hold the two shortlist sums beside them)."""
    from raytracer_tpu_torch.models import whitted
    from raytracer_tpu_torch.ops import cluster_trace as ctr
    from raytracer_tpu_torch.ops import kernels as K

    monkeypatch.setattr(ctr, "SHADOW_PLANES_BYTES_MAX", 0)
    flat = _wavefront(bench)
    assert flat.masks is None and flat.flags.shape == (3,)
    monkeypatch.setattr(ctr, "SUPER_MIN_CPAD", 128)
    wf = _wavefront(bench)
    assert wf.flags.shape == (7,)
    bounces = []
    hier, fused = K.ray_mask_hier, whitted._fused_bounce

    def spy_hier(act, sup, *a):
        bounces[-1] += np.array([int(act.sum()), int(sup.sum())])
        return hier(act, sup, *a)

    def spy_bounce(*a, **k):
        bounces.append(np.zeros(2, np.int64))
        return fused(*a, **k)

    monkeypatch.setattr(K, "ray_mask_hier", spy_hier)
    monkeypatch.setattr(whitted, "_fused_bounce", spy_bounce)
    wf.run()                                  # unsampled
    assert not tracing.samples
    per_bounce = list(bounces)
    assert len(per_bounce) == 3 and all(b[0] > 0 for b in per_bounce)
    assert any(b[1] > b[0] for b in per_bounce)   # tiles in both chunks
    with profile(activities=[ProfilerActivity.CPU]):
        wf.run()
        wf.run()
    assert [b.tolist() for b in bounces[3:]] == [b.tolist()
                                                 for b in per_bounce * 2]
    got = list(zip((s.value for s in tracing.samples if s.name == "mask.tiles"),
                   (s.value for s in tracing.samples if s.name == "mask.chunks")))
    b0, b1, b2 = (tuple(b.tolist()) for b in per_bounce)
    assert got == [b1, tuple(np.add(b2, b0).tolist()), b1]
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        flat.run()
    assert {s.name for s in tracing.samples} == {"wave.active", "wave.lanes",
                                                 "wave.fused", "wave.deep"}


def _record(monkeypatch, samples):
    from raytracer_tpu_torch.tracing import Sample

    rec = types.SimpleNamespace(spans=[], samples=[Sample(*s) for s in samples],
                                totals={})
    monkeypatch.setattr(port_spans, "record", lambda: rec)


def _trace(device):
    """A stretch [0, 200] ns of two frames."""
    spans = [("bench.frame", 0, 100), ("bench.frame", 100, 200)]
    return harness.Trace(list(device), [], spans, [], {})


KERNELS = [("void (anonymous namespace)::ray_mask_hier_kernel(int const*)",
            10, 30),
           ("void (anonymous namespace)::ray_mask_kernel<4, 1>(int const*)",
            30, 60),
           ("void (anonymous namespace)::any_kernel<false, false>(int)",
            60, 100),
           ("void (anonymous namespace)::closest_kernel<false, false, 4, int>()",
            100, 180),
           ("void (anonymous namespace)::any_kernel<false, true>(int)",
            150, 250)]


def test_readers_of_the_route(bench, monkeypatch):
    """(c) ``mask.chunks_per_tile.render``: the stretch's chunk samples
    over its tile samples (a sample after the stretch left out), None
    without tile samples; ``kernels.route_ms.render``: the device ms a
    frame of ``ray_mask_hier_kernel`` and ``any_kernel`` inside the
    stretch, None where neither ran."""
    chunks = bench.reader("mask.chunks_per_tile.render")
    route = bench.reader("kernels.route_ms.render")
    trace = _trace(KERNELS)
    _record(monkeypatch, [("mask.tiles", 20, 1000), ("mask.chunks", 20, 1500),
                          ("mask.tiles", 120, 3000), ("mask.chunks", 120, 4500),
                          ("mask.tiles", 250, 7), ("mask.chunks", 250, 700),
                          ("wave.active", 20, 128000)])
    assert chunks(trace) == pytest.approx(6000 / 4000)
    # 20 + 40 + 50 ns (the last kernel cut at the stretch's end) over 2 frames
    assert route(trace) == pytest.approx(110 / 1e6 / 2)
    _record(monkeypatch, [("wave.active", 20, 128000),
                          ("mask.chunks", 20, 1500)])
    assert chunks(trace) is None
    assert route(_trace(KERNELS[1:2] + KERNELS[3:4])) is None
    monkeypatch.setattr(port_spans, "record", lambda: None)
    assert chunks(trace) is None


def test_cell_names_the_route_metrics(bench):
    """The cell reports both route metrics traced, as the other cell on
    the hierarchical route (``flake66k``) does; the other cells report
    neither."""
    assert CELL in [w["name"] for w in bench.spec["workloads"]]
    hier = {CELL, "flake66k.frame-ssaa2"}
    for w in bench.spec["workloads"]:
        names = {m["name"] for m in bench.metrics(w["name"], True)}
        new = {"mask.chunks_per_tile.render", "kernels.route_ms.render"}
        assert (new <= names) if w["name"] in hier else not (new & names)
    assert os.path.exists(os.path.join(bench.dir, "scenes", CONFIG + ".py"))
