"""The SPD sphereflake configuration ``flake66k`` (``benchmark/scenes``)
and the port's route through it, on the CPU: the generator at size
factor 5; its XML through ``load_scene``; a size-factor-4 flake (58
sphere clusters) from its XML through ``render_one_camera`` with the
hierarchical budget lowered, so that its sphere clusters take the
hierarchical mask and its tiles overflow their sphere shortlists, against
the plain reference under the cell's limits; the wavefront's
``lists.tiles`` / ``lists.over`` and ``wave.deep`` samples; the
compaction's tally; the readers of the two metrics they feed."""

from __future__ import annotations

import copy
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

CONFIG = "flake66k"
CELL = "flake66k.frame-ssaa2"
# 7,381 spheres in 58 clusters, 1 triangle cluster: 128 padded columns,
# hierarchical once SUPER_MIN_CPAD is below that
SMALL = dict(size_factor=4, width=16, height=16)


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


def _levels(parsed, cfg) -> np.ndarray:
    r = np.array([s[2] for s in parsed["spheres"]])
    return np.rint(np.log(cfg["scene"]["root_radius"] / r) / np.log(3)).astype(int)


def test_generator_counts_and_seeds(bench):
    """At its configuration: 66,430 spheres, 9^i at level i of radius
    0.5 / 3^i, each child tangent to its parent; the ground square as 2
    triangles; 2 materials (the spheres' the mirror); 3 lights; the view
    from (2.1, 1.3, 1.7) turned y-up, 512x512.  The same scene for a
    seed; another order of the same spheres for another."""
    from benchmark.scenes import flake66k

    cfg = bench.config(CONFIG)
    a = sceneio.generate(bench, cfg, 2**31 + 7)
    b = sceneio.generate(bench, cfg, 2**31 + 7)
    c = sceneio.generate(bench, cfg, 8)
    assert a["vertices"] == b["vertices"] and a["spheres"] == b["spheres"]
    assert len(a["spheres"]) == cfg["spheres"] == 66_430
    assert np.bincount(_levels(a, cfg)).tolist() == [9**i for i in range(6)]
    va, vc = (np.asarray(x["vertices"]).reshape(-1, 3) for x in (a, c))
    assert not np.array_equal(va, vc)
    key = lambda v, p: sorted(map(tuple, np.concatenate(  # noqa: E731
        [v[4:], [[s[2]] for s in p["spheres"]]], 1)))
    assert key(va, a) == key(vc, c)
    centres, radii, levels = flake66k.flake(cfg)
    parent = np.concatenate([[-1]] + [np.arange(9**i).repeat(9) + (9**i - 1) // 8
                                      for i in range(5)])
    d = np.linalg.norm(centres[1:] - centres[parent[1:]], axis=1)
    np.testing.assert_allclose(d, radii[1:] + radii[parent[1:]], rtol=1e-10)
    np.testing.assert_allclose(radii, 0.5 / 3.0 ** levels)
    assert [m for m, _ in a["meshes"]] == [2] and len(a["meshes"][0][1]) == 2
    assert not a["triangles"]
    assert [m["is_mirror"] for m in a["materials"]] == [True, False]
    assert {s[0] for s in a["spheres"]} == {1}
    assert len(a["point_lights"]) == cfg["lights"] == 3
    assert a["max_depth"] == 6 and a["shadow_eps"] == 1e-4
    cam = a["cameras"][0]
    assert (cam["width"], cam["height"]) == (512, 512)
    assert cam["position"] == [2.1, 1.7, -1.3]
    eye = np.asarray(cam["position"])
    np.testing.assert_allclose(cam["gaze"], -eye / np.linalg.norm(eye))
    np.testing.assert_allclose(np.dot(cam["gaze"], cam["up"]), 0, atol=1e-15)
    assert cam["up"][1] > 0.8
    assert cfg["reduced"] == []
    for key in ("size_factor", "spheres", "children", "child_radius_ratio",
                "polygons", "lights", "width", "height"):
        assert cfg[key] == cfg["published"][key], key


def test_xml_round_trip_through_load_scene(bench, tmp_path):
    """The size-factor-5 scene written as CENG477 XML and loaded by the
    port: every sphere centre and radius in float32, the two ground
    triangles, 3 lights, depth 6, the epsilon 1e-4."""
    from raytracer_tpu_torch.models.scene import load_scene

    parsed = sceneio.generate(bench, bench.config(CONFIG), 2**31 + 3)
    path = str(tmp_path / "flake66k.xml")
    sceneio.write_xml(parsed, path)
    data, meta = load_scene(path, device="cpu")
    assert (meta.n_spheres, meta.n_tris, meta.n_lights) == (66_430, 2, 3)
    assert meta.max_depth == 6 and meta.shadow_eps == pytest.approx(1e-4)
    verts = np.float32(np.asarray(parsed["vertices"]).reshape(-1, 3))
    cvid = data.sphere_cvid[:66_430].numpy()
    np.testing.assert_array_equal(data.vertices.numpy()[cvid],
                                  verts[[s[1] - 1 for s in parsed["spheres"]]])
    np.testing.assert_array_equal(data.sphere_rad[:66_430].numpy(),
                                  np.float32([s[2] for s in parsed["spheres"]]))


def test_flake_route_matches_the_reference(bench, tmp_path, tracing,
                                           stub_graphs, monkeypatch):
    """A size-factor-4 flake from its XML through ``load_scene`` and
    ``render_one_camera`` (SSAA 2 parity, programs on stub graphs, as the
    cell's frames replay them), its budget lowered so that the sphere
    clusters take the hierarchical mask: ``ray_mask_hier`` for every
    per-ray mask, the three lights' shadows in one ``shadow`` launch a
    bounce, tiles past their sphere shortlist's cap, rays past bounce 2.
    Its tiles against the plain reference under the cell's limits."""
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
    assert (accel.tri_cmin.shape[0], accel.sph_cmin.shape[0]) == (1, 58)
    assert not ctr.hierarchical(accel)
    monkeypatch.setattr(ctr, "SUPER_MIN_CPAD", 64)
    assert ctr.hierarchical(accel)
    calls = {"ray_mask_hier": 0, "shadow": 0, "any_hit": 0}

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
    k = 12
    with profile(activities=[ProfilerActivity.CPU]):
        image = render_one_camera(
            data, meta, port_camera(camera_at(cam0, k, tr)), accel,
            ssaa=tr["ssaa"], ssaa_mode=tr["ssaa_mode"], chunk=tr["chunk"],
            engine=tr["engine"], device="cpu")[0]
    assert calls["ray_mask_hier"] > 0 and calls["shadow"] > 0
    assert calls["any_hit"] == 0
    sums = {n: sum(s.value for s in tracing.samples if s.name == n)
            for n in ("lists.tiles", "lists.over", "wave.deep", "wave.active")}
    assert 0 < sums["lists.over"] < sums["lists.tiles"]
    assert 0 < sums["wave.deep"] < sums["wave.active"]

    limits = bench.limits(CELL)
    scene = ref.Scene(parsed, "cpu")
    tiles = np.array([[0, 0]])
    got = ref.tiles_image(scene, camera_at(cam0, k, tr), tr["ssaa"], tiles,
                          imagecheck.TILE).numpy()
    tally = imagecheck.Tally()
    tally.add(got, image, tiles)
    ctx = types.SimpleNamespace(checks=[])
    ctx.check = lambda name, value: ctx.checks.append(
        harness.Check(name, value, limits[name]))
    tally.report(ctx)
    assert tally.pixels == 16 * 16
    assert all(c.ok for c in ctx.checks), ctx.checks


def _wavefront(bench, programs_of=None):
    """A cluster wavefront over a small flake's eye rays (its masks
    hierarchical once the caller lowers the budget): eager, or of the
    programs ``programs_of(data, meta, accel, device)`` gives."""
    from raytracer_tpu_torch.models import programs, whitted
    from raytracer_tpu_torch.models.scene import from_parsed
    from raytracer_tpu_torch.ops.camera import camera_vectors, eye_rays_from
    from raytracer_tpu_torch.render import engine_accel

    parsed = sceneio.generate(bench, _small(bench), 5)
    data, meta = from_parsed(parsed, "cpu")
    accel = engine_accel("auto", None, data, meta, "cpu")
    progs = (programs.EAGER if programs_of is None
             else programs_of(data, meta, accel, "cpu"))
    cam = meta.cameras[0]
    origin, dirs = eye_rays_from(torch.from_numpy(camera_vectors(cam)),
                                 cam.width, cam.height)
    blocks, perm, _ = whitted._tile_order(cam.height, cam.width, "cpu")
    dirs = whitted.apply_tile_order(dirs, cam.height, cam.width, blocks,
                                    perm).contiguous()
    wf = whitted._wavefront(progs, data, meta, accel, dirs.shape[0], True,
                            False, False, "auto", "cpu")
    wf.load(origin, dirs)
    return wf


def test_list_and_deep_samples_count_each_bounce_once(bench, tracing,
                                                      monkeypatch):
    """``lists.tiles`` and ``lists.over``, from the flags the host reads
    between bounces, against the compactions' own counts (the shortlists
    with a candidate, those past their cap) bounce by bounce, shifted as
    ``mask.*`` are (a run's last bounce shows at the next sampled run's
    first read; the first read after an unsampled run sets the base);
    ``wave.deep``: the rays entering each bounce from 2 on, once each.  A
    scene whose masks are flat keeps three flags and the shadow kernel's
    two sums, and samples no ``lists.*``."""
    from raytracer_tpu_torch.models import whitted
    from raytracer_tpu_torch.ops import cluster_trace as ctr
    from raytracer_tpu_torch.ops import kernels as K

    flat = _wavefront(bench)
    assert flat.masks is None and flat.flags.shape == (5,)
    monkeypatch.setattr(ctr, "SUPER_MIN_CPAD", 64)
    wf = _wavefront(bench)
    assert wf.flags.shape == (9,)
    bounces = []
    compact, fused = K.compact, whitted._fused_bounce

    def spy_compact(hit, entry, max_list, tally=None):
        out = compact(hit, entry, max_list, tally)
        bounces[-1] += np.array([int((out[3] > 0).sum()),
                                 int((out[3] > max_list).sum())])
        return out

    def spy_bounce(*a, **k):
        bounces.append(np.zeros(2, np.int64))
        return fused(*a, **k)

    monkeypatch.setattr(K, "compact", spy_compact)
    monkeypatch.setattr(whitted, "_fused_bounce", spy_bounce)
    wf.run()                                  # unsampled
    assert not tracing.samples
    per_bounce = [tuple(b.tolist()) for b in bounces]
    n = len(per_bounce)
    assert n >= 4 and any(b[1] > 0 for b in per_bounce)
    with profile(activities=[ProfilerActivity.CPU]):
        wf.run()
        wf.run()
    assert [tuple(b.tolist()) for b in bounces[n:]] == per_bounce * 2
    got = list(zip((s.value for s in tracing.samples if s.name == "lists.tiles"),
                   (s.value for s in tracing.samples if s.name == "lists.over")))
    if n == wf.meta.max_depth + 1:
        # no read follows the last bounce: the next run's first counts it
        first = tuple(np.add(per_bounce[-1], per_bounce[0]).tolist())
        assert got == per_bounce[1:-1] + [first] + per_bounce[1:-1]
    else:
        # the read that found no ray active counted the last bounce
        assert got == per_bounce[1:] + per_bounce[:1] + per_bounce[1:]
    active = [s.value for s in tracing.samples if s.name == "wave.active"]
    deep = [s.value for s in tracing.samples if s.name == "wave.deep"]
    assert len(active) == 2 * n and deep == active[2:n] + active[n + 2:]
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        flat.run()
    assert {s.name for s in tracing.samples} == {
        "wave.active", "wave.lanes", "wave.fused", "wave.deep",
        "shadow.slots", "shadow.live"}


def test_shadow_samples_count_each_bounce_once(bench, tracing, monkeypatch):
    """``shadow.slots`` and ``shadow.live``, from the flags the host reads
    between bounces, against each bounce's shadow calls made again with a
    tally of their own (the sphere walks' slots, and the rays active and
    not occluded by a triangle as they start), shifted as ``lists.*`` are;
    the live rays are fewer than the slots."""
    from raytracer_tpu_torch.ops import kernels as K
    from raytracer_tpu_torch.models import whitted

    wf = _wavefront(bench)
    assert wf.masks is None and wf.shadow_sums is not None
    bounces = []
    shadow, fused = K.shadow, whitted._fused_bounce

    def spy_shadow(*a):
        own = torch.zeros(2, dtype=torch.int64)
        K.shadow_plain(*a[:12], own)
        bounces[-1] += own.numpy()
        return shadow(*a)

    def spy_bounce(*a, **k):
        bounces.append(np.zeros(2, np.int64))
        return fused(*a, **k)

    monkeypatch.setattr(K, "shadow", spy_shadow)
    monkeypatch.setattr(whitted, "_fused_bounce", spy_bounce)
    wf.run()                                  # unsampled
    per_bounce = [tuple(b.tolist()) for b in bounces]
    n = len(per_bounce)
    assert n >= 4 and all(0 < b[1] < b[0] for b in per_bounce[:2])
    with profile(activities=[ProfilerActivity.CPU]):
        wf.run()
        wf.run()
    assert [tuple(b.tolist()) for b in bounces[n:]] == per_bounce * 2
    got = list(zip((s.value for s in tracing.samples if s.name == "shadow.slots"),
                   (s.value for s in tracing.samples if s.name == "shadow.live")))
    if n == wf.meta.max_depth + 1:
        first = tuple(np.add(per_bounce[-1], per_bounce[0]).tolist())
        assert got == per_bounce[1:-1] + [first] + per_bounce[1:-1]
    else:
        assert got == per_bounce[1:] + per_bounce[:1] + per_bounce[1:]


@pytest.mark.parametrize("config", ["flake66k", "marbles650"])
def test_live_ray_walk_renders_the_same_image(bench, monkeypatch, config):
    """A small flake (its sphere lists past their cap, walked as the
    bitmask) and marbles (650 spheres: the dense walk) rendered on the CPU
    with the shadow calls' ``act`` equal, byte for byte, renders whose
    shadow calls drop it (every ray's bit, as before ``act``); the calls
    had rays outside ``act``."""
    from raytracer_tpu_torch.models.scene import from_parsed
    from raytracer_tpu_torch.ops import cluster_trace as ctr
    from raytracer_tpu_torch.ops import kernels as K
    from raytracer_tpu_torch.pipeline import render_one_camera
    from raytracer_tpu_torch.render import engine_accel

    cfg = copy.deepcopy(bench.config(config))
    cfg["scene"].update(SMALL if config == CONFIG else dict(width=32, height=32))
    if config == CONFIG:
        monkeypatch.setattr(ctr, "SUPER_MIN_CPAD", 64)
    parsed = sceneio.generate(bench, cfg, 2**31 + 7)
    data, meta = from_parsed(parsed, "cpu")
    accel = engine_accel("auto", None, data, meta, "cpu")
    tr = bench.traffic("frame-ssaa2")
    cam = port_camera(camera_at(parsed["cameras"][0], 5, tr))

    def render():
        return render_one_camera(
            data, meta, cam, accel, ssaa=tr["ssaa"], ssaa_mode=tr["ssaa_mode"],
            chunk=tr["chunk"], engine=tr["engine"], device="cpu")[0]

    shadow, acts = K.shadow, []

    def keep_act(*a):
        acts.append(a[11])
        return shadow(*a)

    monkeypatch.setattr(K, "shadow", keep_act)
    want = render()
    assert acts and all(a is not None and not bool(a.all()) for a in acts)
    monkeypatch.setattr(K, "shadow", lambda *a: shadow(*a[:11]))
    got = render()
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_kept_wavefront_makes_every_bounce_step_on_its_first_run(
        bench, stub_graphs):
    """The cell's camera sweep flips the compaction gate of the flake's
    deep bounces from frame to frame, which captured steps inside the
    measured window.  A kept wavefront makes every bounce step before its
    first run, each depth on both sides of the gate and ``uncompact``; the
    run gives the radiance and the kernel launches of an eager one, and
    any later run, however its gate falls, captures nothing."""
    from raytracer_tpu_torch.models import whitted
    from raytracer_tpu_torch.ops import kernels as K

    eager = _wavefront(bench)
    want = eager.run().clone()
    K.reset_launches()
    eager.run()
    launches = dict(K.launches)
    wf = _wavefront(bench, stub_graphs.scene_programs)
    assert wf.warm and not eager.warm
    K.reset_launches()
    c0 = stub_graphs.stats["captures"]
    got = wf.run()
    assert torch.equal(got, want) and K.launches == launches
    depths = range(1, wf.meta.max_depth + 1)
    assert set(wf.steps) == ({(d, False) for d in range(wf.meta.max_depth + 1)}
                             | {(d, True) for d in depths
                                if d >= whitted._COMPACT_FROM}
                             | {("uncompact", True)})
    captures = stub_graphs.stats["captures"]
    assert captures - c0 == len(wf.steps)
    assert torch.equal(wf.run(), want)
    assert stub_graphs.stats["captures"] == captures and not wf.warm


def test_compact_tally_of_the_plain_version():
    """The plain compaction adds [tiles with a hit, tiles past max_list]
    to a tally and leaves its outputs as they are without one."""
    from raytracer_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(4)
    hit = torch.from_numpy(rng.random((16, 40)) < 0.2)
    hit[3] = True
    hit[5] = False
    entry = torch.from_numpy(rng.normal(size=(16, 40)).astype(np.float32))
    tally = torch.tensor([2, 1])
    got = K.compact(hit, entry, 8, tally)
    counts = hit.sum(1)
    assert tally.tolist() == [2 + int((counts > 0).sum()),
                              1 + int((counts > 8).sum())]
    assert 1 <= int((counts > 8).sum()) < 16
    for a, b in zip(got, K.compact(hit, entry, 8)):
        assert torch.equal(a, b)


def _record(monkeypatch, samples):
    from raytracer_tpu_torch.tracing import Sample

    rec = types.SimpleNamespace(spans=[], samples=[Sample(*s) for s in samples],
                                totals={})
    monkeypatch.setattr(port_spans, "record", lambda: rec)


def _trace():
    """A stretch [0, 200] ns of two frames with device work."""
    spans = [("bench.frame", 0, 100), ("bench.frame", 100, 200)]
    return harness.Trace([("closest_kernel", 10, 190)], [], spans, [], {})


def test_readers_of_lists_and_deep_waves(bench, monkeypatch):
    """``lists.overflow_share.render``: the stretch's ``lists.over`` over
    its ``lists.tiles`` samples in percent (a sample after the stretch left
    out), None without ``lists.tiles``; ``wave.deep_share.render``: its
    ``wave.deep`` over its ``wave.active``, None where the program samples
    no ``wave.deep`` (one without the counter)."""
    lists = bench.reader("lists.overflow_share.render")
    deep = bench.reader("wave.deep_share.render")
    trace = _trace()
    _record(monkeypatch, [("lists.tiles", 20, 800), ("lists.over", 20, 100),
                          ("lists.tiles", 120, 1200), ("lists.over", 120, 300),
                          ("lists.tiles", 250, 5), ("lists.over", 250, 5),
                          ("wave.active", 20, 4000), ("wave.active", 120, 1000),
                          ("wave.deep", 120, 1000), ("wave.deep", 250, 900)])
    assert lists(trace) == pytest.approx(100.0 * 400 / 2000)
    assert deep(trace) == pytest.approx(100.0 * 1000 / 5000)
    _record(monkeypatch, [("wave.active", 20, 4000), ("mask.tiles", 20, 8)])
    assert lists(trace) is None and deep(trace) is None
    _record(monkeypatch, [("wave.active", 20, 4000), ("wave.deep", 250, 9)])
    assert deep(trace) == 0.0
    monkeypatch.setattr(port_spans, "record", lambda: None)
    assert lists(trace) is None and deep(trace) is None


def test_reader_of_the_shadow_live_share(bench, monkeypatch):
    """``kernels.shadow_live_share.render``: the stretch's ``shadow.live``
    over its ``shadow.slots`` samples in percent (a sample after the
    stretch left out); None without ``shadow.slots`` (a program without
    the counters, or a scene whose shadow kernel walks no sphere) and
    without the recorder."""
    live = bench.reader("kernels.shadow_live_share.render")
    trace = _trace()
    _record(monkeypatch, [("shadow.slots", 20, 1280), ("shadow.live", 20, 300),
                          ("shadow.slots", 120, 256), ("shadow.live", 120, 84),
                          ("shadow.slots", 250, 128), ("shadow.live", 250, 128)])
    assert live(trace) == pytest.approx(100.0 * 384 / 1536)
    _record(monkeypatch, [("wave.active", 20, 4000), ("lists.tiles", 20, 8)])
    assert live(trace) is None
    _record(monkeypatch, [("shadow.slots", 20, 0), ("shadow.live", 20, 0)])
    assert live(trace) is None
    monkeypatch.setattr(port_spans, "record", lambda: None)
    assert live(trace) is None


def test_cell_names_its_metrics(bench):
    """The cell reports the route's metrics and the two new ones traced;
    ``lists.overflow_share.render`` belongs to the two hierarchical cells,
    ``wave.deep_share.render`` to the two deep mirror cells."""
    owners = {"lists.overflow_share.render": {"terrain524k.frame-ssaa2", CELL},
              "wave.deep_share.render": {"marbles650.frame-ssaa2", CELL},
              "kernels.shadow_live_share.render": {"marbles650.frame-ssaa2",
                                                   CELL}}
    for w in bench.spec["workloads"]:
        names = {m["name"] for m in bench.metrics(w["name"], True)}
        for metric, cells in owners.items():
            assert (metric in names) == (w["name"] in cells), (metric, w)
    names = {m["name"] for m in bench.metrics(CELL, True)}
    assert {"mask.chunks_per_tile.render", "kernels.route_ms.render",
            "kernels.roofline_share.render"} <= names
    assert "glue.fused_share.render" not in names
    assert {m["name"] for m in bench.metrics(CELL, False)} == {
        "setup_s", "mrays_per_s", "peak_mem_gib"}
