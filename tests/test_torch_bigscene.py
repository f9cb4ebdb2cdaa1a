"""The big-scene path of the port (plain PyTorch kernel versions on the
CPU) against the JAX package: the hierarchical cluster mask
(``_super_boxes``, ``ray_mask_hier``), the generic any-hit
(``cluster_any``, the ``any_hit`` kernel), the chunk cap for big scenes
and the chunked ``render_camera``.  Scenes here are small; the routes are
forced by lowering the budgets that pick them (``SHADOW_PLANES_BYTES_MAX``,
``SUPER_MIN_CPAD``).  See torch_port_util for why continuous outputs
carry tolerances."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.ops import cluster_trace as jct
from raytracer_tpu_torch.ops import cluster_trace as pct
from raytracer_tpu_torch.ops import kernels as K
from torch_port_util import assert_same, jax_accel, shared_inputs
from test_torch_shadow import _segments


def _synthetic(c, r, seed=0):
    """Boxes scattered in a cube with every 7th cluster empty (NaN), and
    random rays (5% with a zero x component, 30% inactive) with t windows:
    the inputs of tests/test_hier_mask.py."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-50, 50, (c, 3)).astype(np.float32)
    half = rng.uniform(0.5, 3.0, (c, 3)).astype(np.float32)
    cmin, cmax = centers - half, centers + half
    cmin[:: max(c // 7, 1)] = np.nan
    cmax[:: max(c // 7, 1)] = np.nan
    origin = rng.uniform(-60, 60, (r, 3)).astype(np.float32)
    dirs = rng.standard_normal((r, 3)).astype(np.float32)
    dirs[rng.random(r) < 0.05, 0] = 0.0
    active = rng.random(r) > 0.3
    t_hi = rng.uniform(10, 200, (r,)).astype(np.float32)
    return cmin, cmax, origin, dirs, active, t_hi


@pytest.mark.parametrize("c", [700, 1024, 1100])
def test_super_boxes_equal_jax(c):
    """(a) Bit for bit against the JAX function run op by op, with a chunk
    of only empty clusters (NaN) and a chunk with a single real one."""
    cmin, cmax, *_ = _synthetic(c, 128, seed=c)
    cmin[128:256] = cmax[128:256] = np.nan
    cmin[256:383] = cmax[256:383] = np.nan
    cpad = -(-c // 128) * 128
    with jax.disable_jit():
        jmin, jmax = jct._super_boxes(jnp.asarray(cmin), jnp.asarray(cmax), cpad)
    pmin, pmax = pct._super_boxes(torch.from_numpy(cmin), torch.from_numpy(cmax),
                                  cpad)
    assert pmin.shape == (cpad // 128, 3)
    assert np.isnan(pmin[1].numpy()).all() and not np.isnan(pmin[2].numpy()).any()
    assert_same(pmin.numpy(), jmin, "smin")
    assert_same(pmax.numpy(), jmax, "smax")


def _port_mask(cmin, cmax, origin, dirs, active, t_hi):
    return pct.ray_cluster_mask(*map(torch.from_numpy,
                                     (origin, dirs, active, cmin, cmax, t_hi)), 128)


@pytest.mark.parametrize("c", [700, 1024])
def test_hier_mask_equals_flat_and_eager_jnp(c, monkeypatch):
    """(b) The hierarchical route (cpad > SUPER_MIN_CPAD) equals the flat
    mask exactly, and both equal eager _ray_mask_jnp bit for bit."""
    cmin, cmax, origin, dirs, active, t_hi = _synthetic(c, 2048)
    calls = []
    hier = K.ray_mask_hier
    monkeypatch.setattr(K, "ray_mask_hier", lambda *a: calls.append(1) or hier(*a))
    ph, pe = _port_mask(cmin, cmax, origin, dirs, active, t_hi)
    assert calls, "the hierarchical mask did not run"
    monkeypatch.setattr(pct, "SUPER_MIN_CPAD", 1 << 30)
    fh, fe = _port_mask(cmin, cmax, origin, dirs, active, t_hi)
    assert len(calls) == 1
    assert_same(ph.numpy(), fh.numpy(), "hit vs flat")
    assert_same(pe.numpy(), fe.numpy(), "entry vs flat")
    with jax.disable_jit():
        jh, je = jct._ray_mask_jnp(*map(jnp.asarray, (origin, dirs, active, cmin,
                                                      cmax, t_hi)), 128)
    assert 0 < np.asarray(jh).sum() < jh.size
    assert_same(ph.numpy(), jh, "hit vs jnp")
    assert_same(pe.numpy(), je, "entry vs jnp")


@pytest.mark.parametrize("c", [700, 1024])
def test_hier_mask_matches_pallas_interpret(c):
    """(c) Against the Pallas hierarchical kernel (interpret mode): equal
    hit bits, entries within rtol 1e-4 (the interpreter contracts the slab
    chain into FMAs; tests/test_hier_mask.py's bar)."""
    r = jct.TILE * jct.TPB * 2
    cmin, cmax, origin, dirs, active, t_hi = _synthetic(c, r, seed=3)
    assert -(-c // 128) * 128 > jct._SUPER_MIN_CPAD
    jh, je = jct._ray_cluster_mask_tpu(
        *map(jnp.asarray, (origin, dirs, active, cmin, cmax, t_hi)), jct.TILE,
        interpret=True)
    jh, je = np.asarray(jh), np.asarray(je)
    ph, pe = _port_mask(cmin, cmax, origin, dirs, active, t_hi)
    assert_same(ph.numpy(), jh, "hit")
    np.testing.assert_allclose(pe.numpy(), je, rtol=1e-4)


def test_ray_mask_hier_gates_chunks():
    """ray_mask_hier_plain writes 0 / +inf on exactly the chunks whose
    coarse bit is 0, and the flat result elsewhere (C = 300: a partial
    last chunk)."""
    rng = np.random.default_rng(5)
    cmin, cmax, origin, dirs, active, t_hi = _synthetic(300, 1024, seed=5)
    hit, ent = _port_mask(cmin, cmax, origin, dirs, active, t_hi)
    act, bundle = pct._mask_bundle(*map(torch.from_numpy, (origin, dirs, active,
                                                           t_hi)), 128)
    box = pct._box_table(torch.from_numpy(cmin), torch.from_numpy(cmax))
    sup = torch.from_numpy(rng.integers(0, 2, 8 * 3).astype(np.int32))
    h2, e2 = K.ray_mask_hier(act, sup, box, bundle)
    gate = np.repeat(sup.numpy().reshape(8, 3), 128, axis=1)[:, :300] != 0
    assert_same(h2.numpy(), np.where(gate, hit.numpy(), 0), "hit")
    assert_same(e2.numpy(), np.where(gate, ent.numpy(), np.inf), "entry")


def _case_mask(c):
    return _port_mask(c["cmin"], c["cmax"], c["origin"], c["dirs"], c["active"],
                      c["t_hi"])


def test_hier_case_route_equals_flat_and_eager_jnp(monkeypatch):
    """The hierarchical-mask case (tests/torch_hier_case.py): the port's
    route computes the case's coarse bits (a tile live in every chunk, in
    one, in none; the inactive tile in none), and its result equals the
    flat route and eager _ray_mask_jnp bit for bit, with hits in every
    chunk of the all-live tile, the partial last chunk too."""
    from torch_hier_case import N_TILES, hier_case

    c = hier_case()
    sups = []
    hier = K.ray_mask_hier
    monkeypatch.setattr(K, "ray_mask_hier", lambda *a: sups.append(a[1]) or hier(*a))
    ph, pe = _case_mask(c)
    assert len(sups) == 1
    assert_same(sups[0].numpy().reshape(N_TILES, -1) != 0, c["live"], "coarse bits")
    monkeypatch.setattr(pct, "SUPER_MIN_CPAD", 1 << 30)
    fh, fe = _case_mask(c)
    assert len(sups) == 1
    assert_same(ph.numpy(), fh.numpy(), "hit vs flat")
    assert_same(pe.numpy(), fe.numpy(), "entry vs flat")
    with jax.disable_jit():
        jh, je = jct._ray_mask_jnp(*map(jnp.asarray, (
            c["origin"], c["dirs"], c["active"], c["cmin"], c["cmax"], c["t_hi"])), 128)
    assert_same(ph.numpy(), jh, "hit vs jnp")
    assert_same(pe.numpy(), je, "entry vs jnp")
    per_chunk = np.add.reduceat(ph.numpy()[0], np.arange(0, ph.shape[1], 128))
    assert (per_chunk > 0).all()


def test_hier_case_matches_pallas_interpret():
    """The case against the Pallas hierarchical kernel (interpret mode):
    equal hit bits, entries within rtol 1e-4 (the interpreter contracts the
    slab chain into FMAs; tests/test_hier_mask.py's bar)."""
    from torch_hier_case import hier_case

    c = hier_case()
    assert c["cmin"].shape[0] % 128 and -(-c["cmin"].shape[0] // 128) * 128 > \
        jct._SUPER_MIN_CPAD
    jh, je = jct._ray_cluster_mask_tpu(*map(jnp.asarray, (
        c["origin"], c["dirs"], c["active"], c["cmin"], c["cmax"], c["t_hi"])),
        jct.TILE, interpret=True)
    ph, pe = _case_mask(c)
    assert_same(ph.numpy(), np.asarray(jh), "hit")
    np.testing.assert_allclose(pe.numpy(), np.asarray(je), rtol=1e-4)


@pytest.mark.parametrize("pattern", ["ones", "zeros", "one_tile"])
def test_hier_case_plain_gates_chunks(pattern):
    """ray_mask_hier_plain on the case under all-ones, all-zeros and
    one-tile-live coarse bits: the flat result on exactly the chunks whose
    bit is set in an active tile, 0 / +inf elsewhere (the inactive tile 4
    too, whatever its bits), only the C real columns written."""
    from torch_hier_case import N_TILES, hier_case

    c = hier_case()
    t = torch.from_numpy
    act, bundle = pct._mask_bundle(t(c["origin"]), t(c["dirs"]), t(c["active"]),
                                   t(c["t_hi"]), 128)
    box = pct._box_table(t(c["cmin"]), t(c["cmax"]))
    s = c["live"].shape[1]
    bits = np.full((N_TILES, s), int(pattern == "ones"), np.int32)
    if pattern == "one_tile":
        bits[0] = 1
    fh, fe = K.ray_mask_plain(act, box, bundle)
    h, e = K.ray_mask_hier_plain(act, t(bits.reshape(-1)), box, bundle)
    assert h.shape == fh.shape == (N_TILES, c["cmin"].shape[0])
    gate = np.repeat(bits, 128, axis=1)[:, :h.shape[1]] != 0
    gate &= act.numpy()[:, None] != 0
    assert not gate[4].any() and (gate.any() == (pattern != "zeros"))
    assert_same(h.numpy(), np.where(gate, fh.numpy(), 0), "hit")
    assert_same(e.numpy(), np.where(gate, fe.numpy(), np.inf), "entry")


# ---------------------------------------------------------------------------
# cluster_any
# ---------------------------------------------------------------------------

def _any_ambiguous(cs, org, seg, t_max, lanes):
    """Of ``lanes``, those whose occlusion decision is float32-ambiguous
    when every primitive is recomputed in float64: some triangle hit
    within 1e-4 of an edge (least barycentric) or with t within 1e-5
    relative of t_max or of 0, or some grazing sphere (discriminant within
    1e-3 of b^2) or sphere root within 1e-5 relative of t_max."""
    tri = np.asarray(cs.tri_dat, np.float64)[:, :cs.n_tri]
    sph = np.asarray(cs.sph_dat, np.float64)[:, :cs.n_sph]
    out = []
    for i in lanes:
        o = org[i].astype(np.float64)
        d = seg[i].astype(np.float64)
        tm = float(t_max[i])
        shaky = False
        if tri.shape[1]:
            nd = d @ tri[0:3]
            with np.errstate(divide="ignore", invalid="ignore"):
                t = (tri[9] - o @ tri[0:3]) / nd
            p = o[:, None] + t[None] * d[:, None]
            beta = (p * tri[3:6]).sum(0) - tri[10]
            gamma = (p * tri[6:9]).sum(0) - tri[11]
            m = np.minimum(np.minimum(beta, gamma), 1 - beta - gamma)
            near_t = ((np.abs(t - tm) <= 1e-5 * abs(tm)) | (np.abs(t) <= 1e-5 * abs(tm)))
            inside_t = (t > -1e-5 * abs(tm)) & (t < tm * (1 + 1e-5))
            shaky |= bool(((np.abs(m) < 1e-4) & inside_t).any()
                          | (near_t & (m > -1e-4)).any())
        if sph.shape[1]:
            oc = o[:, None] - sph[0:3]
            a = d @ d
            b = 2 * (d @ oc)
            c = (oc * oc).sum(0) - sph[3] ** 2
            disc = b * b - 4 * a * c
            t1 = (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a)
            t2 = (-b + np.sqrt(np.maximum(disc, 0))) / (2 * a)
            graze = np.abs(disc) <= 1e-3 * b * b
            near_t = (disc >= 0) & ((np.abs(t1 - tm) <= 1e-5 * abs(tm))
                                    | (np.abs(t2) <= 1e-5 * abs(tm)))
            shaky |= bool((graze & (t2 > -1e-3) & (t1 < tm * 1.001)).any()
                          | near_t.any())
        if shaky:
            out.append(i)
    return np.array(out, dtype=np.int64)


ANY_CASES = [(scene, bfc, relaxed)
             for scene in ("terrain64", "spheres600", "spheres1200")
             for bfc in (False, True) for relaxed in (False, True)]


@pytest.mark.parametrize("scene,bfc,relaxed", ANY_CASES)
def test_cluster_any_matches_jax(scene, bfc, relaxed):
    """(d) cluster_any against the JAX package's (the _any_kernel in
    interpret mode) on shadow segments toward a light, half with t_max = 1
    and half with a per-ray t_max in (0, 1): occlusion bits equal on every
    masked lane but the float32-ambiguous ones (at most 1% of them;
    XLA contracts FMAs in the interpreter, the port does not).  terrain64's
    random origins overflow the 48-entry lists (the bitmask scan);
    spheres600 has 5 sphere clusters (the dense rows), spheres1200 10 (the
    walk)."""
    jcs, pcs, org, act, lights = _segments(scene, seed=31)
    _, _, _, cs = jax_accel(scene)
    r = org.shape[0]
    seg = (lights[-1][None] - org).astype(np.float32)
    t_max = np.ones(r, np.float32)
    t_max[r // 2:] = np.random.default_rng(4).uniform(
        0.05, 1.0, r - r // 2).astype(np.float32)
    f = jax.jit(lambda o, s, t, a: jct.cluster_any(
        None, jcs, o, s, t, active=a, bfc=bfc, relaxed=relaxed))
    jocc = np.asarray(f(*map(jnp.asarray, (org, seg, t_max, act))))
    lists = []
    any_hit = K.any_hit
    K.any_hit = lambda *a: lists.append(a) or any_hit(*a)
    try:
        pocc = pct.cluster_any(pcs, torch.from_numpy(org), torch.from_numpy(seg),
                               torch.from_numpy(t_max), active=torch.from_numpy(act),
                               bfc=bfc, relaxed=relaxed).numpy()
    finally:
        K.any_hit = any_hit
    assert len(lists) == 1 and pocc.shape == (r,)
    if scene == "terrain64":
        assert int(lists[0][2].max()) > K.MAX_TRI_LIST  # the bitmask scan
    for half in (slice(0, r // 2), slice(r // 2, r)):
        m = act[half]
        assert 0 < jocc[half][m].sum() < m.sum()
    diff = np.nonzero((jocc != pocc) & act)[0]
    excused = _any_ambiguous(cs, org, seg, t_max, diff)
    print(f"{scene} bfc={bfc} relaxed={relaxed}: {diff.size} lanes differ, "
          f"{excused.size} float32-ambiguous, of {act.sum()} masked")
    assert excused.size == diff.size, f"lanes {sorted(set(diff) - set(excused))}"
    assert excused.size <= act.sum() // 100


def test_any_hit_garbage_lanes_match_kernel_inputs():
    """The kernel module alone on the JAX package's shortlists: every lane
    of a listed tile is tested, inactive ones and t_max 0 ones too; plain
    version and JAX kernel agree on the active lanes (terrain16: no lane
    is ambiguous here)."""
    jcs, pcs, org, act, lights = _segments("terrain16", seed=33)
    _, _, _, cs = jax_accel("terrain16")
    r = org.shape[0]
    seg = (lights[0][None] - org).astype(np.float32)
    t_max = np.where(np.arange(r) % 5 == 0, 0.0, 1.0).astype(np.float32)
    thit, shit = jax.jit(lambda o, d, a, t: jct._cluster_masks(
        jcs, o, d, a, t))(*map(jnp.asarray, (org, seg, act, t_max)))
    jf = np.asarray(jct._cluster_any_call(
        thit, shit, jnp.asarray(org), jnp.asarray(seg), jnp.asarray(t_max)[:, None],
        jcs.tri_dat, jcs.sph_dat, cs.n_tri, cs.n_sph))
    to_t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    lists = pct._lists((to_t(thit[0]), to_t(thit[1])), (to_t(shit[0]), to_t(shit[1])))
    pf = K.any_hit(*lists, to_t(org), to_t(seg), to_t(t_max), pcs.tri_dat,
                   pcs.sph_dat).numpy() != 0
    assert 0 < jf[act].sum() < act.sum()
    assert not pf[t_max == 0].any()
    assert_same(pf[act], jf[act], "found")


# ---------------------------------------------------------------------------
# whole frames, the chunk cap and the chunked render
# ---------------------------------------------------------------------------

def _bad_pixels(a, b):
    d = np.abs(a.astype(int) - b.astype(int)).max(-1)
    return int((d > 1).sum())


def _quantized(c):
    from raytracer_tpu_torch.ops.image import quantize

    return quantize(torch.from_numpy(np.asarray(c))).numpy()


@pytest.mark.parametrize("scene", ["terrain16", "spheres1200"])
def test_big_scene_route_frame_matches_jax(scene, monkeypatch):
    """(e) Whole 64x64 frames with both packages' plane budgets forced to
    0 (every shadow wave takes cluster_any) and the port's SUPER_MIN_CPAD
    at 0 (every exact mask takes the hierarchical route).  Bars of
    test_torch_render: at most 4 pixels > 1 LSB on the terrain; on the
    sphere field fewer than 1% of pixels > 1 LSB and at most 3% outside
    rtol 1e-4 / atol 1e-3."""
    from raytracer_tpu.models.whitted import render_camera as jrender
    from raytracer_tpu_torch.models.whitted import render_camera

    jdata, jcs, pdata, pmeta, pcs = shared_inputs(scene)
    _, meta, _, _ = jax_accel(scene)
    spies = {"jax_any": 0, "port_any": 0, "hier": 0}

    def spy(mod, name, key):
        f = getattr(mod, name)

        def wrapped(*a, **k):
            spies[key] += 1
            return f(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    monkeypatch.setattr(jct, "SHADOW_PLANES_BYTES_MAX", 0)
    monkeypatch.setattr(pct, "SHADOW_PLANES_BYTES_MAX", 0)
    monkeypatch.setattr(pct, "SUPER_MIN_CPAD", 0)
    spy(jct, "cluster_any", "jax_any")
    spy(pct, "cluster_any", "port_any")
    spy(K, "ray_mask_hier", "hier")
    # render_rays reads the budget while it traces: no cached trace
    jax.clear_caches()
    try:
        jc = np.array(jrender(jdata, meta, meta.cameras[0], bvh=jcs))
    finally:
        jax.clear_caches()
    pc = render_camera(pdata, pmeta, pmeta.cameras[0], pcs, device="cpu").numpy()
    assert spies["jax_any"] > 0 and spies["port_any"] > 0 and spies["hier"] > 0
    assert np.isfinite(pc).all() and pc.shape == jc.shape
    n = jc.shape[0] * jc.shape[1]
    bad = _bad_pixels(_quantized(pc), _quantized(jc))
    if scene == "terrain16":
        assert bad <= 4
        assert (~np.isclose(pc, jc, rtol=1e-4, atol=1e-3).all(-1)).sum() <= 4
    else:
        assert bad < 0.01 * n
        assert (~np.isclose(pc, jc, rtol=1e-4, atol=1e-3).all(-1)).sum() <= 0.03 * n


@pytest.mark.parametrize("pt,ps", [(128, 128), (131072, 128), (131200, 128),
                                   (128, 131200), (262144, 1024)])
@pytest.mark.parametrize("chunk", [1 << 22, 1 << 16, 131200])
def test_cap_chunk_equals_jax(pt, ps, chunk):
    """(f) The chunk cap against the JAX function on cluster sets of the
    same table widths."""
    from raytracer_tpu.models.whitted import _cap_chunk_for_big_scenes as jcap
    from raytracer_tpu_torch.models.whitted import _cap_chunk_for_big_scenes as pcap

    _, jcs, _, _, pcs = shared_inputs("entry")
    jset = dataclasses.replace(jcs, tri_dat=np.broadcast_to(np.float32(0), (12, pt)),
                               sph_dat=np.broadcast_to(np.float32(0), (4, ps)))
    pset = dataclasses.replace(pcs, tri_dat=torch.zeros(()).expand(12, pt),
                               sph_dat=torch.zeros(()).expand(4, ps))
    assert pcap(chunk, pset) == jcap(chunk, jset)


@pytest.mark.parametrize("chunk", [1024, 1280])
def test_chunked_render_equals_whole_frame(chunk):
    """(g) render_camera in chunks of whole tiles (1280: the last chunk
    padded) equals the whole-frame render bit for bit (terrain16, max
    depth 2: no compaction, so every ray meets the same tiles)."""
    from raytracer_tpu_torch.models.whitted import render_camera

    _, _, pdata, pmeta, pcs = shared_inputs("terrain16")
    assert pmeta.max_depth == 2
    cam = pmeta.cameras[0]
    whole = render_camera(pdata, pmeta, cam, pcs, device="cpu")
    calls = []
    from raytracer_tpu_torch.models import whitted

    run = whitted._Wavefront.run
    whitted._Wavefront.run = lambda self: calls.append(self.r) or run(self)
    try:
        parts = render_camera(pdata, pmeta, cam, pcs, chunk=chunk, device="cpu")
    finally:
        whitted._Wavefront.run = run
    assert calls == [chunk] * -(-cam.width * cam.height // chunk)
    assert torch.equal(parts, whole)
