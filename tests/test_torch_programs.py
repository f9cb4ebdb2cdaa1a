"""The port's compiled render programs on the CPU (``models.programs``;
the cluster engine's bounce loop, bands and cameras as steps on static
buffers, ``models.whitted``): the restructured loop against PR 9's loop
(frozen in torch_port_util) bit for bit and against the JAX package at
its bars; the band program run in place, with ``row0``, the camera
vector and the jitter as tensor inputs, against the JAX package's
``_render_band_jit`` at its bars; programs replayed through a stub graph
(``StubGraph``) against eager renders; an eager render keeping nothing;
the launch bookkeeping of a replay; the server's LRU dropping a scene's
programs.  On the card the same programs are CUDA graphs
(tests/test_torch_gpu.py, chip_smoke.py)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import torch_port_util as U
from torch_port_util import (  # noqa: F401 (stub_graphs: a fixture)
    ENTRY_XML, bad_pixels, jax_accel, jax_band_jitter, numpy_fields, port_meta,
    radiance_outside, shared_inputs, stub_graphs,
)


@functools.lru_cache(maxsize=None)
def _mirror_spheres():
    """(jax data, jax cset, jax meta, port data, port meta, port cset): a
    600-sphere field at max depth 3 whose spheres are all mirrors (tint
    0.8), so that the reflected wave scatters and the compaction gate is
    taken; the JAX package's clusters handed to the port."""
    import jax
    import jax.numpy as jnp

    from raytracer_tpu.models.bvh import build_bvh
    from raytracer_tpu.models.clusters import build_clusters
    from raytracer_tpu.utils import synth
    from raytracer_tpu_torch.convert import clusters_from_numpy, scene_from_numpy

    data, meta = synth.sphere_field(n_spheres=600, res=64, max_depth=3)
    data = dataclasses.replace(
        data, mat_is_mirror=jnp.ones_like(data.mat_is_mirror),
        mat_mirror=jnp.full_like(data.mat_mirror, 0.8))
    cs = build_clusters(data, meta, build_bvh(data, meta))
    pdata = scene_from_numpy(numpy_fields(data), "cpu")
    pcs = clusters_from_numpy(numpy_fields(cs), "cpu")
    return (jax.device_put(data), jax.device_put(cs), meta, pdata,
            port_meta(meta), pcs)


def _scene(name):
    """(jax data, jax cset, jax meta, port data, port meta, port cset)."""
    if name == "mirror_spheres":
        return _mirror_spheres()
    jdata, jcs, pdata, pmeta, pcs = shared_inputs(name)
    return jdata, jcs, jax_accel(name)[1], pdata, pmeta, pcs


def _eye_rays(meta):
    """(origin (3,), dirs (H*W, 3)) of the scene's camera in tile order."""
    from raytracer_tpu_torch.models.whitted import _tile_order
    from raytracer_tpu_torch.ops.camera import camera_vectors, eye_rays_from
    from raytracer_tpu_torch.ops.tiling import apply_tile_order

    cam = meta.cameras[0]
    origin, dirs = eye_rays_from(torch.from_numpy(camera_vectors(cam)),
                                 cam.width, cam.height)
    blocks, perm, _ = _tile_order(cam.height, cam.width, "cpu")
    return origin, apply_tile_order(dirs, cam.height, cam.width, blocks,
                                    perm).contiguous()


@pytest.fixture
def compactions(monkeypatch):
    """The depths at which the port's loop took the compaction branch."""
    from raytracer_tpu_torch.models import whitted

    calls = []
    compact = whitted._compact_carry
    monkeypatch.setattr(whitted, "_compact_carry",
                        lambda c: calls.append(c[0]) or compact(c))
    return calls


# (a) the restructured loop against PR 9's: entry (max depth 3, the gate
# on and not taken), the mirror sphere field (the gate taken), the 64x64
# terrain (max depth 2, the gate off); shared and per-ray origins
@pytest.mark.parametrize("scene,shared", [
    ("entry", True), ("entry", False), ("mirror_spheres", True),
    ("mirror_spheres", False), ("terrain64", True)])
def test_render_rays_equals_pr9_loop(scene, shared, compactions):
    from raytracer_tpu_torch.models.whitted import render_rays

    _, _, _, pdata, pmeta, pcs = _scene(scene)
    origin, dirs = _eye_rays(pmeta)
    if not shared:
        origin = origin.expand(dirs.shape).contiguous()
    U.pr9_compactions.clear()
    want = U.pr9_render_rays(pdata, pmeta, origin, dirs, pcs)
    got = render_rays(pdata, pmeta, origin, dirs, pcs)
    assert torch.equal(got, want)
    assert compactions == U.pr9_compactions
    if scene == "mirror_spheres":
        assert compactions, "the compaction gate was never taken"
    else:
        assert not compactions


def test_render_rays_deep_compaction_equals_pr9_loop(compactions):
    """compact_mode="deep" (adaptive's refinement waves) on the terrain at
    max depth 2: only the runtime gate decides, as in PR 9's loop."""
    from raytracer_tpu_torch.models.whitted import render_rays

    _, _, _, pdata, pmeta, pcs = _scene("terrain64")
    origin, dirs = _eye_rays(pmeta)
    U.pr9_compactions.clear()
    want = U.pr9_render_rays(pdata, pmeta, origin, dirs, pcs,
                             compact_mode="deep")
    got = render_rays(pdata, pmeta, origin, dirs, pcs, compact_mode="deep")
    assert torch.equal(got, want)
    assert compactions == U.pr9_compactions


# (b) the JAX package's bars: at most 4 pixels outside rtol 1e-4 / atol
# 1e-3 and fewer than 1% of pixels > 1 LSB; on the sphere field the JAX
# side's FMA-contracted sphere quadratic moves t in its last digits, and
# mirrors carry that on (test_torch_render's sphere-field bar: at most 3%
# outside the radiance bar)
@pytest.mark.parametrize("scene", ["entry", "mirror_spheres", "terrain64"])
def test_render_rays_within_jax_bars(scene):
    import jax.numpy as jnp

    from raytracer_tpu.models.whitted import render_rays as jax_render_rays
    from raytracer_tpu_torch.models.whitted import render_rays
    from raytracer_tpu_torch.ops.image import quantize

    jdata, jcs, jmeta, pdata, pmeta, pcs = _scene(scene)
    origin, dirs = _eye_rays(pmeta)
    got = render_rays(pdata, pmeta, origin, dirs, pcs)
    want = np.asarray(jax_render_rays(
        jdata, jmeta, jnp.asarray(origin.numpy()), jnp.asarray(dirs.numpy()),
        bvh=jcs, engine="cluster"))
    n = dirs.shape[0]
    assert np.isfinite(got.numpy()).all()
    assert bad_pixels(quantize(got).numpy(),
                      quantize(torch.tensor(want)).numpy()) < 0.01 * n
    limit = 0.03 * n if scene == "mirror_spheres" else 4
    assert radiance_outside(got.numpy(), want) <= limit


# (c) the band program with tensor inputs against the JAX package's band
# with a traced row0: the 64x64 terrain's first band whole; the last,
# shorter band of a 24x20 camera (8x16 blocks do not divide it: the
# permutation); a band of the 64x64 frame traced as several chunks, the
# last padded
BANDS = {
    "whole": dict(cam=None, band=0, chunk=1 << 22),
    "last": dict(cam=(24, 20), band=-1, chunk=1 << 22),
    "chunked": dict(cam=None, band=1, chunk=1000),
}


def _band_case(case, ssaa):
    """(data, meta, cset, camera, hs, ws, row0, bh, chunk)."""
    _, _, pdata, pmeta, pcs = shared_inputs("terrain16")
    spec = BANDS[case]
    cam = pmeta.cameras[0]
    if spec["cam"] is not None:
        cam = dataclasses.replace(cam, width=spec["cam"][0],
                                  height=spec["cam"][1])
    hs, ws = cam.height * ssaa, cam.width * ssaa
    lcm = 16 * ssaa // np.gcd(16, ssaa)
    starts = list(range(0, hs, lcm))
    row0 = starts[spec["band"]]
    bh = min(lcm if case != "chunked" else 2 * lcm, hs - row0)
    if case == "whole":
        bh = hs
    return pdata, pmeta, pcs, cam, hs, ws, row0, bh, spec["chunk"]


@pytest.mark.parametrize("case", list(BANDS))
@pytest.mark.parametrize("mode,ssaa,hdr", [
    ("parity", 1, False), ("parity", 2, False), ("mean", 2, False),
    ("jitter", 2, False), ("mean", 2, True)])
def test_band_program_equals_render_band(case, mode, ssaa, hdr):
    """The band program run in place (``_Frame`` of ``programs.EAGER``,
    what ``render_band`` runs off the card), ``row0``, the camera vector
    and the jitter its tensor inputs, against the JAX package's
    ``_render_band_jit`` on the same band, camera and draws (seed 3), at
    test_torch_streamed's band bars: at most 4 pixels off by more than 1
    LSB, or outside the radiance bar for hdr."""
    import jax.numpy as jnp

    from raytracer_tpu.models.whitted import _render_band_jit
    from raytracer_tpu.ops.tiling import block_permutation, divides
    from raytracer_tpu_torch.models import programs, whitted
    from raytracer_tpu_torch.ops.camera import camera_vectors

    data, meta, cset, cam, hs, ws, row0, bh, chunk = _band_case(case, ssaa)
    vec = torch.from_numpy(camera_vectors(cam))
    offsets = None
    if mode == "jitter":
        offsets = torch.tensor(jax_band_jitter(3)(("band", row0),
                                                      (bh, ws, 2)))
    frame = whitted._Frame(programs.EAGER, data, meta, cset, "band", hs, ws,
                           bh, chunk, ssaa, mode, hdr, offsets is not None,
                           False, False, "cpu")
    assert frame.rays.whole == (case != "chunked")
    got = frame(vec, row0, offsets).numpy()
    jdata, jcs = shared_inputs("terrain16")[:2]
    bh_, bw_ = whitted._tile_block_shape()
    blocks = perm = inv = None
    if divides(bh, ws, bh_, bw_):
        blocks = (bh_, bw_)
    else:
        perm, inv = map(jnp.asarray, block_permutation(bh, ws, bh_, bw_))
    want = np.asarray(_render_band_jit(
        jdata, jax_accel("terrain16")[1], jnp.asarray(vec.numpy()), hs, ws,
        jnp.float32(row0), bh, perm, inv, jcs, "cluster", False, ssaa, mode,
        blocks=blocks, hdr=hdr, seed=jnp.uint32(3)))
    assert got.dtype == want.dtype and got.shape == want.shape
    if hdr:
        assert np.isfinite(got).all() and radiance_outside(got, want) <= 4
    else:
        assert got.max() > 0 and bad_pixels(got, want) <= 4


# programs replayed through the stub graph: every band of one shape shares
# one capture, row0 / the camera vector / the jitter copied in anew
@pytest.mark.parametrize("case", ["whole", "last", "chunked"])
@pytest.mark.parametrize("mode", ["parity", "jitter"])
def test_streamed_replays_equal_eager(stub_graphs, case, mode):
    from raytracer_tpu_torch.models.whitted import render_camera_streamed

    data, meta, cset, cam, _, ws, _, _, _ = _band_case(case, 2)
    chunk = {"whole": ws * 16, "last": ws * 16, "chunked": ws * 16 // 3}[case]
    kw = dict(ssaa=2, ssaa_mode=mode, chunk=chunk, device="cpu",
              jitter=jax_band_jitter(5) if mode == "jitter" else None)
    with stub_graphs.eager():
        want = render_camera_streamed(data, meta, cam, cset, **kw)
    assert not stub_graphs._scenes
    for _ in range(2):            # captures, then replays only
        got = render_camera_streamed(data, meta, cam, cset, **kw)
        assert torch.equal(got, want)
    progs = stub_graphs.scene_programs(data, meta, cset, "cpu")
    frames = [k for k in progs if k[0] == "frame"]
    n_bands = -(-cam.height * 2 // 16)
    assert len(frames) == (2 if case == "last" else 1) < n_bands


def test_camera_and_rays_replays_equal_eager(stub_graphs, compactions):
    """render_camera of two cameras of one resolution (one capture) and
    render_rays of two ray sets through the compacting steps, each equal to
    its eager render."""
    from raytracer_tpu_torch.models.whitted import render_camera, render_rays

    _, _, _, data, meta, cset = _scene("mirror_spheres")
    cams = [meta.cameras[0], dataclasses.replace(
        meta.cameras[0], position=(5.0, 45.0, 70.0))]
    for cam in cams * 2:
        with stub_graphs.eager():
            want = render_camera(data, meta, cam, cset, device="cpu")
        assert torch.equal(render_camera(data, meta, cam, cset, device="cpu"),
                           want)
    origin, dirs = _eye_rays(meta)
    rng = np.random.default_rng(0)
    for k in range(3):
        d = dirs + torch.from_numpy(
            rng.normal(0, 0.01 * k, dirs.shape).astype(np.float32))
        with stub_graphs.eager():
            want = render_rays(data, meta, origin, d, cset)
        n = len(compactions)
        assert torch.equal(render_rays(data, meta, origin, d, cset), want)
        assert len(compactions) > n
    progs = stub_graphs.scene_programs(data, meta, cset, "cpu")
    assert sorted(k[0] for k in progs) == ["frame", "rays"]


def test_inplace_edit_makes_new_programs(stub_graphs):
    """A scene tensor edited in place (the light moves: new shadow plane
    tables) keys new programs; the frame equals the eager render."""
    from raytracer_tpu_torch.models.whitted import render_camera

    _, _, pdata, meta, cset = shared_inputs("terrain16")
    data = dataclasses.replace(pdata, light_pos=pdata.light_pos.clone())
    cam = meta.cameras[0]
    render_camera(data, meta, cam, cset, device="cpu")
    first = stub_graphs.scene_programs(data, meta, cset, "cpu")
    data.light_pos.add_(torch.tensor([3.0, 1.0, -2.0]))
    with stub_graphs.eager():
        want = render_camera(data, meta, cam, cset, device="cpu")
    assert torch.equal(render_camera(data, meta, cam, cset, device="cpu"), want)
    assert stub_graphs.scene_programs(data, meta, cset, "cpu") is not first


def test_eager_and_debug_nans_keep_no_programs(stub_graphs):
    from raytracer_tpu_torch.models.whitted import debug_nans, render_camera

    _, _, data, meta, cset = shared_inputs("terrain16")
    with stub_graphs.eager():
        render_camera(data, meta, meta.cameras[0], cset, device="cpu")
    with debug_nans():
        render_camera(data, meta, meta.cameras[0], cset, device="cpu")
    assert stub_graphs.cached(data) == 0
    render_camera(data, meta, meta.cameras[0], cset, device="cpu")
    assert stub_graphs.cached(data) > 0


def test_eager_render_keeps_nothing():
    """Off the card every render runs its programs in place
    (``programs.EAGER``) and keeps nothing: after ``render_camera_streamed``
    (two bands, jittered, on a 2-shard mesh), ``render_camera`` (cluster,
    in chunks, and BVH), ``render_band``, ``trace`` and
    ``render_camera_adaptive``, no program is kept for the scene and no
    wavefront, ray, frame, shard or adaptive program made by them is
    alive, with the garbage collector off (no reference cycle holds one)
    and after it has run.  Under ``debug_nans()`` a NaN still names its
    band, and its adaptive wave."""
    import gc

    from raytracer_tpu_torch.models import programs, whitted
    from raytracer_tpu_torch.ops import adaptive
    from raytracer_tpu_torch.ops.camera import camera_vectors
    from raytracer_tpu_torch.parallel.mesh import make_mesh
    from raytracer_tpu_torch.render import engine_accel

    _, _, data, meta, cset = shared_inputs("terrain16")
    bvh = engine_accel("bvh", None, data, meta, "cpu")
    cam = meta.cameras[0]
    ws = cam.width * 2
    vec = torch.from_numpy(camera_vectors(cam))
    origin, dirs = _eye_rays(meta)
    kinds = (whitted._Wavefront, whitted._Rays, whitted._Frame,
             whitted._MeshFrame, whitted._Shard, adaptive._Adaptive)

    def alive():
        return {id(o) for o in gc.get_objects() if type(o) in kinds}

    streamed = functools.partial(whitted.render_camera_streamed, data, meta,
                                 cam, cset, ssaa=2, device="cpu")
    renders = {
        "streamed": lambda: streamed(chunk=ws * 32),
        "jitter": lambda: streamed(ssaa_mode="jitter", seed=3, chunk=ws * 32),
        "mesh": lambda: streamed(mesh=make_mesh(devices=["cpu"] * 2)),
        "camera": lambda: whitted.render_camera(data, meta, cam, cset,
                                                chunk=1000, device="cpu"),
        "bvh": lambda: whitted.render_camera(data, meta, cam, bvh,
                                             device="cpu", engine="bvh"),
        "band": lambda: whitted.render_band(
            data, meta, cset, vec, 2 * cam.height, ws, 16, 16, ssaa=2,
            ssaa_mode="parity", hdr=False, chunk=1000),
        "trace": lambda: whitted.trace(data, meta, origin.expand(dirs.shape),
                                       dirs, cset, 1000),
        "adaptive": lambda: adaptive.render_camera_adaptive(
            data, meta, cam, cset, base_spp=2, extra_spp=2, rounds=2,
            device="cpu"),
    }
    gc.collect()
    before = alive()
    collecting = gc.isenabled()
    gc.disable()
    try:
        for name, render in renders.items():
            render()
            assert alive() <= before, name
    finally:
        if collecting:
            gc.enable()
    gc.collect()
    assert alive() <= before and programs.cached(data) == 0
    bad = dataclasses.replace(data, mat_diffuse=data.mat_diffuse * np.nan)
    with whitted.debug_nans():
        with pytest.raises(FloatingPointError, match=r"^band of rows \d+-\d+: "
                           r"radiance not finite after bounce 0$"):
            whitted.render_camera_streamed(bad, meta, cam, cset, ssaa=2,
                                           chunk=ws * 32, device="cpu")
        with pytest.raises(FloatingPointError, match=r"^adaptive base wave 0: "
                           r"radiance not finite after bounce 0$"):
            adaptive.render_camera_adaptive(bad, meta, cam, cset, device="cpu")
    assert programs.cached(bad) == 0


# (d) launch bookkeeping: a capture traces the body (its wrappers count in
# Python) but runs nothing; a replay runs the kernels without Python
class _Tracing:
    def __init__(self, pool):
        pass

    def capture(self, body):
        body()

    def replay(self):
        pass


class _Refusing(_Tracing):
    def capture(self, body):
        body()
        raise RuntimeError("operation not permitted when stream is capturing")


def test_replay_adds_launches_of_capture():
    from raytracer_tpu_torch.models import programs
    from raytracer_tpu_torch.ops import kernels

    ran = []

    def body():
        ran.append(1)
        kernels.launches["closest"] += 2
        kernels.launches["shadow"] += 1

    kernels.reset_launches()
    step = programs.Step("bounce 1", body, lambda: _Tracing(None))
    step()                        # eager run, then the capture
    assert len(ran) == 2 and step.launches == {"closest": 2, "shadow": 1}
    assert kernels.launches["closest"] == 2 and kernels.launches["shadow"] == 1
    step()
    step()
    assert len(ran) == 2
    assert kernels.launches["closest"] == 6 and kernels.launches["shadow"] == 3
    assert sum(kernels.launches.values()) == 9
    kernels.reset_launches()


def test_failed_capture_raises_naming_the_step():
    from raytracer_tpu_torch.models import programs
    from raytracer_tpu_torch.ops import kernels

    kernels.reset_launches()
    step = programs.Step("band prologue",
                         lambda: kernels.launches.__setitem__(
                             "ray_mask", kernels.launches["ray_mask"] + 1),
                         lambda: _Refusing(None))
    with pytest.raises(RuntimeError, match="'band prologue' failed: Runtime"
                       "Error: operation not permitted"):
        step()
    assert kernels.launches["ray_mask"] == 1 and step.graph is None
    kernels.reset_launches()


# (e) the server's LRU drops an evicted scene's programs
def test_server_lru_drops_programs(stub_graphs, tmp_path):
    import shutil

    from raytracer_tpu_torch.serve import RenderServer

    other = tmp_path / "other.xml"
    shutil.copy(ENTRY_XML, other)
    server = RenderServer(max_scenes=1, mesh="1", device="cpu")
    r = server.handle({"scene": ENTRY_XML, "out_dir": str(tmp_path / "a")})
    assert r["ok"], r
    (data, _, _), = server._scenes.values()
    assert stub_graphs.cached(data) > 0
    r = server.handle({"scene": str(other), "out_dir": str(tmp_path / "b")})
    assert r["ok"], r
    (data2, _, _), = server._scenes.values()
    assert stub_graphs.cached(data) == 0 and stub_graphs.cached(data2) > 0
    assert all(p.refs[0] is not data for p in stub_graphs._scenes.values())
