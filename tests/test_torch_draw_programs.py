"""The jitter draw inside the port's compiled programs on the CPU: the
threefry draw keyed from a tensor (``ops.kernels.threefry_uniform_keyed``,
its plain version here; ``csrc/threefry.cu`` reads the key from device
memory on the card) against ``jax.random.uniform`` and the host-key draw
bit for bit; jittered bands (``models.whitted._Frame``, on a mesh
``_MeshFrame``) and the adaptive frame (``ops.adaptive._Adaptive``) that
draw their offsets in their prologues, as ``_render_band_jit`` and
``_adaptive_jit`` draw inside themselves, replayed through ``StubGraph``
against the same programs run in place (``programs.eager()``) and the
JAX package's draws; the key written into the static tensor between
replays (a body that ignored it would replay the first band's draw); the
injected ``jitter`` route as a program of its own.  On the card the
same programs are CUDA graphs (tests/test_torch_gpu.py, chip_smoke.py
phases 6b, 9 and 10)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (  # noqa: F401 (stub_graphs: a fixture)
    jax_adaptive_jitter, jax_band_jitter, shared_inputs, stub_graphs,
)

import test_torch_adaptive

SEEDS = [0, 3, 2**31 + 5, 2**32 - 1]


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _key_tensor(seed, key):
    from raytracer_tpu_torch.ops.camera import jitter_key

    return torch.tensor(jitter_key(seed, key), dtype=torch.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keyed_draw_matches_jax_and_host_key(seed):
    """The keyed plain draw (``draw_jitter_into``: the key words read from a
    tensor) equals ``jax.random.uniform`` under JAX's own keys bit for bit,
    bands at several rows, the adaptive base wave and rounds 0 and 1, and
    equals the host-key plain draw."""
    from raytracer_tpu_torch.ops import kernels as K
    from raytracer_tpu_torch.ops.camera import draw_jitter_into, jitter_key

    band, adaptive = jax_band_jitter(seed), jax_adaptive_jitter(seed)
    for key, shape, ref in ([(("band", r), (16, 24, 2), band)
                             for r in (0, 16, 48, 2032)]
                            + [(("base", 0), (3, 4, 128, 2), adaptive),
                               (("round", 0), (2, 6, 128, 2), adaptive),
                               (("round", 1), (5, 7, 2), adaptive)]):
        out = torch.full(shape, float("nan"))
        got = draw_jitter_into(_key_tensor(seed, key), out)
        assert got is out
        np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref(key, shape)),
                                      err_msg=str(key))
        k0, k1 = jitter_key(seed, key)
        host = K.threefry_uniform_plain(k0, k1, out.numel(), -0.5, 0.5)
        assert torch.equal(out.view(-1).view(torch.int32), host.view(torch.int32))


def test_keyed_draw_reads_the_low_32_bits_of_each_word():
    """The kernel reads each int64 key word's low 32 bits; so does the plain
    version: words with other high bits (negative ones too) draw the same
    floats, in [0, 1) as in [-0.5, 0.5)."""
    from raytracer_tpu_torch.ops import kernels as K

    k0, k1 = 0x9E3779B9, 0x7F4A7C15
    want = K.threefry_uniform_plain(k0, k1, 1000, 0.0, 1.0)
    for words in ([k0, k1], [k0 + (5 << 32), k1 - (3 << 32)],
                  [k0 - (1 << 32), k1 + (1 << 40)]):
        out = K.threefry_uniform_keyed(torch.tensor(words, dtype=torch.int64),
                                       torch.empty(1000), 0.0, 1.0)
        assert torch.equal(out.view(torch.int32), want.view(torch.int32))
    assert sum(K.launches.values()) == 0


def test_keyed_draw_off_the_cpu_checks_then_launches(monkeypatch):
    """Off the CPU the keyed wrapper takes the kernel: a key of another
    shape or type raises before any launch, and a kernel that cannot be
    built raises (nothing falls back to the plain version)."""
    from raytracer_tpu_torch import backend
    from raytracer_tpu_torch.ops import kernels as K

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(backend, "_state", {})
    monkeypatch.setattr(backend, "library_path", lambda: "/nonexistent/lib.so")
    monkeypatch.setattr(backend, "_nvcc", no_nvcc)
    K.reset_launches()
    out = torch.empty((4, 2), device="meta")
    for key, err in ((torch.zeros(3, dtype=torch.int64), "shape"),
                     (torch.zeros(2, dtype=torch.int32), "dtype")):
        with pytest.raises(ValueError, match=err):
            K.threefry_uniform_keyed(key.to("meta"), out, -0.5, 0.5)
    with pytest.raises(ValueError, match="expected meta"):
        K.threefry_uniform_keyed(torch.zeros(2, dtype=torch.int64), out, 0, 1)
    with pytest.raises(RuntimeError, match="nvcc"):
        K.threefry_uniform_keyed(torch.zeros(2, dtype=torch.int64,
                                             device="meta"), out, -0.5, 0.5)
    assert sum(K.launches.values()) == 0


def _terrain_cam():
    _, _, data, meta, cset = shared_inputs("terrain16")
    return data, meta, cset, meta.cameras[0]


@pytest.fixture
def band_spy(monkeypatch):
    """(row0, the static jitter, the key tensor) after every band program
    run (``_Frame.__call__``)."""
    from raytracer_tpu_torch.models import whitted

    seen = []
    call = whitted._Frame.__call__

    def spy(self, vec, row0=0, jitter=None, seed=0):
        out = call(self, vec, row0, jitter, seed)
        seen.append((row0, None if self.jitter is None else self.jitter.clone(),
                     None if self.key is None else self.key.clone()))
        return out
    monkeypatch.setattr(whitted._Frame, "__call__", spy)
    return seen


def _frames(progs, jitter):
    return [(k, f) for k, f in progs.items()
            if k[0] == "frame" and k[9] == jitter]


@pytest.mark.parametrize("seed", [3, 2**32 - 1])
def test_streamed_jitter_bands_draw_inside_the_program(stub_graphs, band_spy,
                                                       seed):
    """A jittered camera at --ssaa 2 cut into 4 bands of 32 rows, its band
    program captured on the first frame and replayed on every later band
    and frame: equal bit for bit to the eager render (``eager()``: the
    same band program run in place, its draw too); after each band, eager
    or replayed, the program's static ``jitter`` holds JAX's draw for that
    band's row, its ``key`` the words of ``fold_in(PRNGKey(seed),
    row0)``."""
    from raytracer_tpu_torch.models.whitted import render_camera_streamed
    from raytracer_tpu_torch.ops.camera import jitter_key

    data, meta, cset, cam = _terrain_cam()
    ws = cam.width * 2
    kw = dict(ssaa=2, ssaa_mode="jitter", seed=seed, chunk=ws * 32,
              device="cpu")
    with stub_graphs.eager():
        want = render_camera_streamed(data, meta, cam, cset, **kw)
    assert [r for r, _, _ in band_spy] == [0, 32, 64, 96]
    assert not stub_graphs._scenes
    c0 = stub_graphs.stats["captures"]
    for frame in range(2):
        got = render_camera_streamed(data, meta, cam, cset, **kw)
        assert torch.equal(got, want), f"frame {frame}"
    progs = stub_graphs.scene_programs(data, meta, cset, "cpu")
    assert len(_frames(progs, "drawn")) == 1 and not _frames(progs, "given")
    c1 = stub_graphs.stats["captures"]
    assert c1 > c0
    render_camera_streamed(data, meta, cam, cset, **kw)
    assert stub_graphs.stats["captures"] == c1
    draw = jax_band_jitter(seed)
    rows = [r for r, _, _ in band_spy]
    assert rows == [0, 32, 64, 96] * 4
    for row0, jit, key in band_spy:
        assert tuple(key.tolist()) == jitter_key(seed, ("band", row0))
        np.testing.assert_array_equal(_bits(jit.numpy()),
                                      _bits(draw(("band", row0), (32, ws, 2))),
                                      err_msg=f"band at row {row0}")


def test_key_overwrite_replays_that_bands_draw(stub_graphs):
    """After the band program is captured, another band's key words written
    into its static ``key`` and the prologue replayed alone: the static
    ``jitter`` holds that band's draw (a prologue that read the key
    anywhere but from the tensor would keep the last band's)."""
    from raytracer_tpu_torch.models.whitted import render_camera_streamed
    from raytracer_tpu_torch.ops.camera import write_jitter_keys

    data, meta, cset, cam = _terrain_cam()
    ws = cam.width * 2
    render_camera_streamed(data, meta, cam, cset, ssaa=2, ssaa_mode="jitter",
                           seed=5, chunk=ws * 32, device="cpu")
    progs = stub_graphs.scene_programs(data, meta, cset, "cpu")
    [(_, frame)] = _frames(progs, "drawn")
    assert frame.prologue.graph is not None          # captured: replays
    last = frame.jitter.clone()
    draw = jax_band_jitter(5)
    np.testing.assert_array_equal(_bits(last.numpy()),
                                  _bits(draw(("band", 96), (32, ws, 2))))
    for seed, row0 in ((5, 32), (11, 4000), (5, 0)):
        write_jitter_keys(frame.key_words, seed, [("band", row0)])
        frame.prologue()
        np.testing.assert_array_equal(
            _bits(frame.jitter.numpy()),
            _bits(jax_band_jitter(seed)(("band", row0), (32, ws, 2))),
            err_msg=f"seed {seed}, row {row0}")
        assert not torch.equal(frame.jitter, last)


def refuse_host_key_draw(monkeypatch) -> list:
    """From now on the host-key draws raise; returns the shapes of the
    keyed draws, appended as they run."""
    from raytracer_tpu_torch.ops import kernels as K

    def refuse(*a, **kw):
        raise AssertionError("the host-key draw was called")

    keyed = []
    draw = K.threefry_uniform_keyed

    def counted(*a):
        keyed.append(a[1].shape)
        return draw(*a)
    monkeypatch.setattr(K, "threefry_uniform", refuse)
    monkeypatch.setattr(K, "threefry_uniform_plain", refuse)
    monkeypatch.setattr(K, "threefry_uniform_keyed", counted)
    return keyed


def test_drawn_programs_never_call_the_host_key_draw(stub_graphs,
                                                    monkeypatch):
    """A jittered streamed frame and an adaptive frame with nothing
    injected, captured then replayed, with the host-key draw refusing every
    call: the same images as the eager renders, the keyed draw run once a
    band and once a wave."""
    from raytracer_tpu_torch.models.whitted import render_camera_streamed
    from raytracer_tpu_torch.ops.adaptive import render_camera_adaptive

    data, meta, cset, cam = _terrain_cam()
    ws = cam.width * 2
    band_kw = dict(ssaa=2, ssaa_mode="jitter", seed=7, chunk=ws * 48,
                   device="cpu")
    ada_kw = dict(base_spp=3, extra_spp=5, refine_frac=0.25, rounds=2,
                  seed=7, device="cpu")
    with stub_graphs.eager():
        want_band = render_camera_streamed(data, meta, cam, cset, **band_kw)
        want_ada, _ = render_camera_adaptive(data, meta, cam, cset, **ada_kw)
    keyed = refuse_host_key_draw(monkeypatch)
    for _ in range(2):                 # captures, then replays
        keyed.clear()
        assert torch.equal(render_camera_streamed(data, meta, cam, cset,
                                                  **band_kw), want_band)
        assert keyed == [(48, ws, 2), (48, ws, 2), (32, ws, 2)]
        keyed.clear()
        img, _ = render_camera_adaptive(data, meta, cam, cset, **ada_kw)
        assert torch.equal(img, want_ada) and len(keyed) == 3


@pytest.mark.parametrize("rounds", [1, 2])
def test_adaptive_drawn_program_equals_eager(stub_graphs, monkeypatch, rounds):
    """The adaptive frame with nothing injected: its program (each wave's
    draw in its prologue) captured, then replayed, equals the same program
    run in place (``eager()``) bit for bit: image, stats, each round's
    block scores and the draws, one keyed draw a wave on both sides."""
    from raytracer_tpu_torch.ops import adaptive
    from raytracer_tpu_torch.ops import kernels as K

    data, meta, cset, cam = _terrain_cam()
    kw = dict(base_spp=4, extra_spp=6, refine_frac=0.25, rounds=rounds,
              seed=2**32 + 9, device="cpu")
    scores, draws = [], []
    topk = adaptive.stable_topk
    monkeypatch.setattr(adaptive, "stable_topk",
                        lambda s, k: scores.append(s.clone()) or topk(s, k))
    for name in ("threefry_uniform_keyed", "threefry_uniform"):
        fn = getattr(K, name)
        monkeypatch.setattr(K, name, lambda *a, fn=fn, name=name:
                            draws.append(name) or fn(*a))
    with stub_graphs.eager():
        want, wstats = adaptive.render_camera_adaptive(data, meta, cam, cset,
                                                       **kw)
    assert draws == ["threefry_uniform_keyed"] * (1 + rounds)
    want_scores = scores[:]
    for _ in range(2):                 # captures, then replays
        scores.clear()
        draws.clear()
        img, stats = adaptive.render_camera_adaptive(data, meta, cam, cset, **kw)
        assert torch.equal(img, want) and stats == wstats
        assert draws == ["threefry_uniform_keyed"] * (1 + rounds)
        assert len(scores) == rounds
        for a, b in zip(scores, want_scores):
            assert torch.equal(a, b)
    progs = stub_graphs.scene_programs(data, meta, cset, "cpu")
    assert [k[-1] for k in progs if k[0] == "adaptive"] == ["drawn"]


@pytest.mark.parametrize("case", [test_torch_adaptive.CASES[i] for i in (0, 1)])
def test_adaptive_drawn_program_meets_jax_bars(stub_graphs, case, monkeypatch):
    """test_torch_adaptive's bars against the JAX package's
    ``render_camera_adaptive`` (seed 11, nothing injected) through the
    drawn program: the first render captures, the second replays."""
    c0 = stub_graphs.stats["captures"]
    test_torch_adaptive.test_adaptive_matches_jax(*case, monkeypatch)
    c1 = stub_graphs.stats["captures"]
    assert c1 > c0
    test_torch_adaptive.test_adaptive_matches_jax(*case, monkeypatch)
    assert stub_graphs.stats["captures"] == c1


def test_injected_jitter_is_a_given_program(stub_graphs, band_spy):
    """A caller's ``jitter`` (``recorded_jitter``: a render's draws recorded
    and replayed in another) runs the "given" band and adaptive programs,
    which copy the offsets in: the recorded samples, so the same images as
    the drawn programs, and the given band's static jitter is the
    recorded array."""
    from raytracer_tpu_torch.models.whitted import render_camera_streamed
    from raytracer_tpu_torch.ops.adaptive import render_camera_adaptive
    from raytracer_tpu_torch.ops.camera import recorded_jitter

    data, meta, cset, cam = _terrain_cam()
    ws = cam.width * 2
    band_kw = dict(ssaa=2, ssaa_mode="jitter", seed=4, chunk=ws * 64,
                   device="cpu")
    ada_kw = dict(base_spp=3, extra_spp=4, refine_frac=0.25, seed=4,
                  device="cpu")
    drawn = render_camera_streamed(data, meta, cam, cset, **band_kw)
    drawn_ada, _ = render_camera_adaptive(data, meta, cam, cset, **ada_kw)
    record, replay = recorded_jitter(4, "cpu")
    recorded = render_camera_streamed(data, meta, cam, cset, jitter=record,
                                      **band_kw)
    band_spy.clear()
    replayed = render_camera_streamed(data, meta, cam, cset, jitter=replay,
                                      **band_kw)
    for img in (recorded, replayed):
        assert torch.equal(img, drawn)
    assert [r for r, _, _ in band_spy] == [0, 64]
    for row0, jit, key in band_spy:
        assert key is None
        assert torch.equal(jit, replay(("band", row0), None))
    for jit in (record, replay):
        img, _ = render_camera_adaptive(data, meta, cam, cset, jitter=jit,
                                        **ada_kw)
        assert torch.equal(img, drawn_ada)
    progs = stub_graphs.scene_programs(data, meta, cset, "cpu")
    assert len(_frames(progs, "given")) == len(_frames(progs, "drawn")) == 1
    assert sorted(k[-1] for k in progs if k[0] == "adaptive") == [
        "drawn", "given"]


@pytest.mark.parametrize("scene", ["entry", "terrain16"])
def test_two_shard_drawn_band_equals_one_device(stub_graphs, scene):
    """A jittered band on a 2-shard mesh (its drawn ``_MeshFrame``, the draw
    on the mesh's first device) equals the one-device drawn band bit for
    bit, captured and replayed, at the same band rows."""
    from raytracer_tpu_torch.models.whitted import render_camera_streamed
    from raytracer_tpu_torch.parallel.mesh import make_mesh

    _, _, data, meta, cset = shared_inputs(scene)
    cam = meta.cameras[0]
    kw = dict(ssaa=2, ssaa_mode="jitter", seed=6, chunk=cam.width * 2 * 64,
              device="cpu")
    mesh = make_mesh(devices=["cpu"] * 2)
    single = render_camera_streamed(data, meta, cam, cset, **kw)
    with stub_graphs.eager():
        assert torch.equal(render_camera_streamed(data, meta, cam, cset, **kw),
                           single)
    for _ in range(2):
        assert torch.equal(render_camera_streamed(data, meta, cam, cset,
                                                  mesh=mesh, **kw), single)
    progs = stub_graphs.scene_programs(data, meta, cset, "cpu")
    assert [k[-1] for k, _ in _frames(progs, "drawn")].count(mesh) == 1


@pytest.mark.parametrize("seed", [-1, 2**32 + 7])
def test_band_seed_out_of_range_raises_before_capture(stub_graphs, seed):
    """The drawn band program raises OverflowError for a seed out of [0,
    2**32) (JAX's ``jnp.uint32(seed)``) before any step runs or is
    captured."""
    from raytracer_tpu_torch.models.whitted import render_camera_streamed

    data, meta, cset, cam = _terrain_cam()
    c0 = stub_graphs.stats["captures"]
    with pytest.raises(OverflowError, match="uint32"):
        render_camera_streamed(data, meta, cam, cset, ssaa=2,
                               ssaa_mode="jitter", seed=seed, device="cpu")
    assert stub_graphs.stats["captures"] == c0


def test_keyed_draw_of_jax_package_band_shapes():
    """The band draw of a JAX package streamed frame (``uniform(fold_in(
    PRNGKey(seed), row0), (rows, W, 2))``) against ``jax.random`` directly,
    at a shape whose element count is not a multiple of the kernel's
    256-thread block."""
    from raytracer_tpu_torch.ops.camera import draw_jitter_into

    shape = (3, 37, 2)
    out = torch.empty(shape)
    draw_jitter_into(_key_tensor(9, ("band", 144)), out)
    want = jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(9), 144),
                              shape, jnp.float32, minval=-0.5, maxval=0.5)
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(want))
