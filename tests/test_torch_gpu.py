"""On a machine with a CUDA card: each kernel equals its plain version on
the card (run with ``python -m pytest tests/test_torch_gpu.py -m gpu``;
``chip_smoke.py`` does the same at full size).  Skips without a card."""

import contextlib
import dataclasses

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


SCENES = [
    ("terrain_scene", dict(cells=40, mirror_stripes=True)),
    ("sphere_field", dict(n_spheres=1200)),
    ("sphere_field", dict(n_spheres=600)),
]


@pytest.mark.parametrize("scene,kw", SCENES)
def test_kernels_equal_plain_on_card(cuda, scene, kw):
    _render_and_compare(cuda, scene, kw, ("ray_mask", "closest", "shadow"))


@pytest.mark.parametrize("scene,kw", SCENES)
@pytest.mark.parametrize("bfc,relaxed", [(False, False), (True, True)])
def test_big_scene_kernels_equal_plain_on_card(cuda, scene, kw, bfc, relaxed,
                                               monkeypatch):
    """The big-scene route forced on small scenes: no plane tables (every
    shadow wave takes any_hit) and the hierarchical mask at any size."""
    from raytracer_tpu_torch.ops import cluster_trace

    monkeypatch.setattr(cluster_trace, "SHADOW_PLANES_BYTES_MAX", 0)
    monkeypatch.setattr(cluster_trace, "SUPER_MIN_CPAD", 0)
    _render_and_compare(cuda, scene, kw, ("ray_mask_hier", "any_hit"),
                        bfc=bfc, relaxed=relaxed)


@pytest.mark.parametrize("scene,kw", SCENES[:2])
def test_treelet_kernels_equal_plain_on_card(cuda, scene, kw):
    """Treelet clusters (padded gaps among the terrain's triangle slots):
    every kernel call of the frame equals its plain version."""
    _render_and_compare(cuda, scene, kw, ("ray_mask", "closest", "shadow"),
                        treelet=True)


def _render_and_compare(cuda, scene, kw, names, treelet=False, **render_kw):
    """Render at 64x64 on the card (``scene``: a ``utils.synth`` scene's
    name, or a function of the device giving (data, meta)), keeping the
    inputs of every call of the wrappers ``names``; then each call's
    kernel equals its plain version.  Returns the calls."""
    from raytracer_tpu_torch.models.bvh import build_bvh
    from raytracer_tpu_torch.models.clusters import build_clusters
    from raytracer_tpu_torch.models.whitted import eager, render_camera
    from raytracer_tpu_torch.ops import kernels as K
    from raytracer_tpu_torch.utils import synth

    data, meta = (scene(cuda) if callable(scene)
                  else getattr(synth, scene)(res=64, device=cuda, **kw))
    cset = build_clusters(data, meta, build_bvh(data, meta), treelet=treelet)
    calls = []
    wrapped = {n: getattr(K, n) for n in names}

    def spy(name):
        def f(*a):
            calls.append((name, a))
            return wrapped[name](*a)
        return f

    for n in wrapped:
        setattr(K, n, spy(n))
    try:
        # eager: a replayed graph calls no wrapper
        with eager():
            render_camera(data, meta, dataclasses.replace(meta.cameras[0]),
                          cset, device=cuda, **render_kw)
    finally:
        for n, f in wrapped.items():
            setattr(K, n, f)
    assert {n for n, _ in calls} == set(names)
    for name, args in calls:
        out_k = wrapped[name](*args)
        out_p = getattr(K, name + "_plain")(*args)
        out_k = out_k if isinstance(out_k, tuple) else (out_k,)
        out_p = out_p if isinstance(out_p, tuple) else (out_p,)
        for a, b in zip(out_k, out_p):
            assert torch.equal(a, b), name
    return calls


def test_flake_kernels_equal_plain_on_card(cuda):
    """The benchmark's SPD sphereflake (66,430 spheres in 519 clusters) at
    64x64: its masks hierarchical over sphere columns, tiles past their
    sphere shortlist's cap walking the bitmask, three lights in one shadow
    launch, mirror bounces to depth 6.  Every ray_mask_hier, closest and
    shadow call of an eager frame equals its plain version."""
    import copy

    from benchmark import sceneio
    from benchmark.paths import Bench

    from raytracer_tpu_torch.models.scene import from_parsed
    from raytracer_tpu_torch.ops import kernels as K

    def flake(device):
        bench = Bench()
        cfg = copy.deepcopy(bench.config("flake66k"))
        cfg["scene"].update(width=64, height=64)
        return from_parsed(sceneio.generate(bench, cfg, 2**31 + 5), device)

    calls = _render_and_compare(cuda, flake, {},
                                ("ray_mask_hier", "closest", "shadow"))
    over = [int((a[5] > K.MAX_SPH_LIST).sum()) for n, a in calls
            if n == "closest"]
    assert sum(over) > 0
    assert all(a[0].shape[0] == 3 for n, a in calls if n == "shadow")
    # each shadow call passed its rays' activity, which the kernel took
    assert all(a[11] is not None and not bool(a[11].all())
               for n, a in calls if n == "shadow")


HIT_FIELDS = ("hit", "normal", "mat", "point", "offset", "mask")
CARRY_FIELDS = ("color", "throughput", "active", "cur_org", "cur_dir")


def _equal_fields(got, want, names, what):
    for name, a, b in zip(names, got, want):
        if not torch.equal(a, b):
            d = (a.double() - b.double()).abs()
            raise AssertionError(
                f"{what}: {name} differs on {int((a != b).sum())} of "
                f"{a.numel()}, by at most {float(d.max())}")


@pytest.mark.parametrize("scene", ["terrain2sph", "terrain7l", "mirror_field",
                                   "entry", "nolight", "any"])
def test_epilogue_kernels_equal_plain_on_card(cuda, scene, monkeypatch):
    """The forward bounce epilogue's kernels on every call of a 64x64 frame
    (two small spheres and two lights, the shadow_multi route; the same
    with seven lights, one below the terrain, up to six lit on a lane, so
    the kernel's light accumulators 0 and 1 each add two lights; mirror
    spheres at depth 4, compacted; one light, per light; no light; the
    any-hit route): each output equals the plain version's on every lane.
    Each shade_bounce call runs twice, into new buffers and in place (an
    inactive lane returns after its flag), where its carry came in its
    own buffers; their inactive lanes carry throughput 0, which the early
    return rests on."""
    from torch_port_util import epilogue_calls, epilogue_scene

    from raytracer_tpu_torch.models.bvh import build_bvh
    from raytracer_tpu_torch.models.clusters import build_clusters
    from raytracer_tpu_torch.models.whitted import eager, render_camera
    from raytracer_tpu_torch.ops import cluster_trace as ctr
    from raytracer_tpu_torch.ops import kernels as K

    if scene == "any":
        monkeypatch.setattr(ctr, "SHADOW_PLANES_BYTES_MAX", 0)
    data, meta = epilogue_scene(scene, cuda)
    cset = build_clusters(data, meta, build_bvh(data, meta))
    before = dict(K.launches)
    with epilogue_calls() as calls, eager():
        render_camera(data, meta, meta.cameras[0], cset, device=cuda)
    assert K.launches["hit_record"] - before["hit_record"] == \
        K.launches["shade_bounce"] - before["shade_bounce"] == len(calls) // 2
    inplace = inactive = 0
    for i, call in enumerate(calls):
        what = f"{call.name} call {i}"
        if call.name == "hit_record":
            h, mask = ctr.hit_record(*call.again())
            h_p, mask_p = ctr.hit_record_plain(*call.again())
            assert h.t is h_p.t is None, what
            _equal_fields((h.hit, *h[2:], mask), (h_p.hit, *h_p[2:], mask_p),
                          HIT_FIELDS, what)
            continue
        want = ctr.shade_bounce_plain(*call.again())
        _equal_fields(ctr.shade_bounce(*call.again()), want, CARRY_FIELDS,
                      what + " into new buffers")
        if call.inplace:
            args = call.again()
            carry = args[3]
            idle = ~carry[2]
            assert bool((carry[1][idle] == 0).all()), what
            got = ctr.shade_bounce(*args, out=carry)
            assert all(g is c for g, c in zip(got, carry))
            _equal_fields(got, want, CARRY_FIELDS, what + " in place")
            inplace += 1
            inactive += int(idle.sum())
    assert inplace and (inactive or meta.max_depth == 0)
    if scene == "mirror_field":
        assert any(not c.inplace and not c.args[6] for c in calls
                   if c.name == "shade_bounce"), "no compacted bounce"


@pytest.mark.parametrize("width", ["16-warp", "4-warp"])
def test_tie_case_kernels_equal_plain_on_card(cuda, width):
    """The exact-tie case (tests/torch_tie_case.py: duplicated and
    edge-sharing triangles across clusters, sphere-triangle ties, list
    overflows, a sphere-only and an empty tile): closest in both call
    shapes and any_hit, each with every template instance, equal their
    plain versions on the card, in both block widths (a launch of a few
    tiles per SM takes 16-warp blocks; the case repeated to a whole
    frame's 32,768 tiles takes 4-warp blocks).  Either way several warps
    split each tile's work and merge their winners."""
    import numpy as np

    from raytracer_tpu_torch import backend
    from raytracer_tpu_torch.ops import cluster_trace as pct
    from raytracer_tpu_torch.ops import kernels as K
    from torch_tie_case import N_TILES, tie_case

    reps = 1 if width == "16-warp" else 32768 // N_TILES
    threads = backend.launch_threads(reps * N_TILES)
    assert threads == (512 if width == "16-warp" else 128)
    c = tie_case()
    on = lambda x: torch.from_numpy(np.ascontiguousarray(  # noqa: E731
        np.tile(x, (reps,) + (1,) * (np.ndim(x) - 1)))).to(cuda)
    lists = pct._lists(tuple(map(on, c["thit"])), tuple(map(on, c["shit"])))
    tri = torch.from_numpy(c["tri_dat"]).to(cuda)
    sph = torch.from_numpy(c["sph_dat"]).to(cuda)
    eye = torch.from_numpy(c["eye"]).to(cuda)
    for o, d in ((on(c["origin"]), on(c["dirs"])), (eye, on(c["eye_dirs"]))):
        for bfc in (False, True):
            args = (*lists, o, d, tri, sph, bfc)
            for a, b in zip(K.closest(*args), K.closest_plain(*args)):
                assert torch.equal(a, b), f"closest origin {tuple(o.shape)} bfc={bfc}"
    for bfc in (False, True):
        for relaxed in (False, True):
            args = (*lists, on(c["origin"]), on(c["dirs"]), on(c["t_max"]), tri,
                    sph, bfc, relaxed)
            assert torch.equal(K.any_hit(*args), K.any_hit_plain(*args)), \
                f"any bfc={bfc} relaxed={relaxed}"


# tiles of the live-ray case: its active rays a tile (8 kinds, each light
# its own), the 33-ray and 50% kinds over two words and more
_ACT_KINDS = (0, 1, 31, 32, "word", 33, 128, "half")


def _live_ray_case(cuda, size_factor, n_lights, seed=3):
    """A sphereflake (benchmark/scenes; size factor 5: 519 sphere clusters,
    walked by list or bitmask; 3: 7, walked densely) and its ground square,
    with 48 tiles of 128 shadow origins, each tile's clustered around a
    point above the ground: (lists, lps, origin, planes, sph_dat, act).
    Lights: the scene's, one below the ground (its triangles occlude every
    segment toward it), then random ones, the first ``n_lights``.  Tile t
    is active toward light l by ``_ACT_KINDS[(t + l) % 8]``."""
    import copy

    import numpy as np

    from benchmark import sceneio
    from benchmark.paths import Bench
    from raytracer_tpu_torch.models.bvh import build_bvh
    from raytracer_tpu_torch.models.clusters import build_clusters
    from raytracer_tpu_torch.models.scene import from_parsed
    from raytracer_tpu_torch.ops import cluster_trace as pct

    bench = Bench()
    cfg = copy.deepcopy(bench.config("flake66k"))
    cfg["scene"].update(width=32, height=32, size_factor=size_factor)
    data, meta = from_parsed(sceneio.generate(bench, cfg, 2**31 + 3), cuda)
    cset = build_clusters(data, meta, build_bvh(data, meta))
    rng = np.random.default_rng(seed)
    tmin, tmax = (x[0].cpu().numpy() for x in (cset.tri_cmin, cset.tri_cmax))
    smin = np.nanmin(cset.sph_cmin.cpu().numpy(), 0)
    smax = np.nanmax(cset.sph_cmax.cpu().numpy(), 0)
    up = int(np.argmin(tmax - tmin))              # the ground's normal axis
    sign = 1.0 if smax[up] > tmax[up] else -1.0
    below = 0.5 * (tmin + tmax)
    below[up] -= sign * 5.0
    n_tiles = 48
    ext = smax - smin
    centers = rng.uniform(smin - 0.3 * ext, smax + 0.3 * ext, (n_tiles, 3))
    centers[:, up] = tmax[up] + sign * rng.uniform(0.05, 1.0, n_tiles) * ext[up]
    org = centers[:, None] + rng.normal(0, 0.03 * ext, (n_tiles, 128, 3))
    org[..., up] = np.maximum(sign * org[..., up], sign * tmax[up] + 1e-3) * sign
    org = org.reshape(-1, 3).astype(np.float32)
    lights = data.light_pos[:meta.n_lights].cpu().numpy()
    around = rng.uniform(smin - ext, smax + ext, (32, 3))
    around[:, up] = smax[up] + sign * rng.uniform(0.5, 3.0, 32)
    pool = np.concatenate([lights[:1], below[None], lights[1:], around])
    lps = pool[:n_lights].astype(np.float32)
    act = np.zeros((n_lights, n_tiles, 128), bool)
    for l in range(n_lights):
        for t in range(n_tiles):
            kind = _ACT_KINDS[(t + l) % len(_ACT_KINDS)]
            if kind == "word":
                act[l, t, 64:96] = True
            elif kind == "half":
                act[l, t] = rng.random(128) < 0.5
            else:
                act[l, t, rng.permutation(128)[:kind]] = True
    origin = torch.from_numpy(org).to(cuda)
    ones = torch.ones((origin.shape[0],), device=cuda)
    per_light = []
    for l, lp in enumerate(lps):
        dirs = torch.from_numpy(lp).to(cuda)[None] - origin
        per_light.append(pct._lists(*pct._cluster_masks(
            cset, origin, dirs, torch.from_numpy(act[l].reshape(-1)).to(cuda),
            ones)))
    lists = [torch.stack(x) for x in zip(*per_light)]
    planes = torch.stack([pct.build_shadow_planes(cset, torch.from_numpy(lp).to(cuda))
                          for lp in lps])
    return (lists, torch.from_numpy(lps.reshape(-1)).to(cuda), origin, planes,
            cset.sph_dat, torch.from_numpy(act.reshape(n_lights, -1)).to(cuda))


@pytest.mark.parametrize("width", ["16-warp", "4-warp"])
@pytest.mark.parametrize("n_lights", [1, 3, 32])
@pytest.mark.parametrize("size_factor", [5, 3])
def test_shadow_live_ray_walk_equals_plain_on_card(cuda, width, n_lights,
                                                   size_factor):
    """The live-ray sphere walks (size factor 5: the lists and the
    bitmask; 3: the dense pass) with ``act``: tiles with no live ray, 1,
    31, 32 (scattered and one whole word), 33 and 128, rays the ground's
    planes already occlude (the light below it), 1, 3 and 32 lights, relaxed
    off and on, in both block widths (the 48 tiles repeated to 2,304 take
    4-warp blocks): bits and tally equal the plain version's, and without
    ``act`` as well."""
    import numpy as np

    from raytracer_tpu_torch import backend
    from raytracer_tpu_torch.ops import kernels as K

    lists, lps, origin, planes, sph, act = _live_ray_case(cuda, size_factor,
                                                          n_lights)
    reps = 1 if width == "16-warp" else 48
    if reps > 1:
        nl = planes.shape[0]
        rep = lambda x: x.view(nl, 48, -1).repeat(1, reps, 1).view(nl, -1)  # noqa: E731
        lists = [rep(x) for x in lists]
        origin = origin.repeat(reps, 1)
        act = rep(act)
    assert backend.launch_threads(origin.shape[0] // 128) == (
        512 if width == "16-warp" else 128)
    cs = sph.shape[1] // K.CLUSTER
    sc = lists[5]
    if size_factor == 5:
        assert bool(((sc > 0) & (sc <= K.MAX_SPH_LIST)).any())
        assert bool((sc > K.MAX_SPH_LIST).any())
    else:
        assert cs <= K.DENSE_SPH_ROWS and bool((sc > 0).any())
    for relaxed in (False, True):
        args = (*lists, lps, origin, planes, sph, relaxed)
        assert torch.equal(K.shadow(*args), K.shadow_plain(*args))
        for a in (act, act.to(torch.uint8), act.T.contiguous().T):
            t_k = torch.zeros(2, dtype=torch.int64, device=cuda)
            t_p = torch.zeros_like(t_k)
            got = K.shadow(*args, a, t_k)
            want = K.shadow_plain(*args, a, t_p)
            assert torch.equal(got, want), f"relaxed={relaxed}"
            assert torch.equal(t_k, t_p), (t_k.tolist(), t_p.tolist())
        slots, live = t_k.tolist()
        assert 0 < live < slots
    if n_lights > 1:
        # light 1 is below the ground: its triangles occlude every ray
        bit = ((got >> 1) & 1).view(-1, 128).cpu().numpy()
        assert np.array_equal(bit, act[1].view(-1, 128).cpu().numpy())


@pytest.mark.parametrize("width", ["16-warp", "4-warp"])
@pytest.mark.parametrize("n_lights", [1, 2])
def test_poison_case_shadow_equals_plain_on_card(cuda, width, n_lights):
    """The NaN-poison case (tests/torch_poison_case.py: a lane >= 0 in one
    visit and NaN in another, in the same and in different warp groups,
    does not occlude) through the shadow kernel, relaxed off and on, equal
    to its plain version and to the running-max rule, in both block widths
    (the case repeated to a whole frame's 32,768 tiles takes 4-warp
    blocks); with a random ``act``, the same bits ANDed with it."""
    import numpy as np

    from raytracer_tpu_torch import backend
    from raytracer_tpu_torch.ops import cluster_trace as pct
    from raytracer_tpu_torch.ops import kernels as K
    from torch_poison_case import N_TILES, poison_case

    reps = 1 if width == "16-warp" else 32768 // N_TILES
    assert backend.launch_threads(reps * N_TILES) == (512 if width == "16-warp" else 128)
    c = poison_case(n_lights)
    rep = lambda x: torch.from_numpy(np.ascontiguousarray(  # noqa: E731
        np.tile(x, (reps,) + (1,) * (np.ndim(x) - 1)))).to(cuda)
    shit = tuple(map(rep, c["shit"]))
    lists = [torch.stack(x) for x in zip(*(pct._lists(tuple(map(rep, th)), shit)
                                           for th in c["thit"]))]
    truth = torch.from_numpy(np.tile(c["truth"], reps))
    act = torch.from_numpy(np.random.default_rng(7).random(
        (n_lights, truth.shape[0])) < 0.7).to(cuda)
    bits = (act.to(torch.int32) << torch.arange(
        n_lights, dtype=torch.int32, device=cuda)[:, None]).sum(0).cpu()
    for relaxed in (False, True):
        args = (*lists, torch.from_numpy(c["lps"]).to(cuda), rep(c["origin"]),
                torch.from_numpy(c["planes"]).to(cuda),
                torch.from_numpy(c["sph_dat"]).to(cuda), relaxed)
        got = K.shadow(*args)
        assert torch.equal(got, K.shadow_plain(*args)), f"relaxed={relaxed}"
        assert torch.equal(got.cpu(), truth)
        got = K.shadow(*args, act)
        assert torch.equal(got, K.shadow_plain(*args, act)), f"relaxed={relaxed}"
        assert torch.equal(got.cpu(), truth & bits)


@pytest.mark.parametrize("c", [1, 32, 64, 65, 249, 512])
def test_ray_mask_equals_plain_on_card(cuda, c):
    """The flat mask at every column count that picks another instance (the
    rays split over 4 or 2 thread groups up to 32 and 64 columns, one
    column a thread up to 128, two above), on random rays and boxes with
    zero direction components, inactive rays and tiles without an active
    ray; and the hierarchical mask on random coarse bits."""
    import numpy as np

    from raytracer_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(c)
    nt = 64
    act_t, box, bundle = _mask_inputs(rng, nt, c, cuda)
    flat = K.ray_mask(act_t, box, bundle)
    for a, b in zip(flat, K.ray_mask_plain(act_t, box, bundle)):
        assert torch.equal(a, b)
    assert bool(flat[0].any()) and not bool(flat[0][3].any())
    sup = torch.from_numpy((rng.random(nt * -(-c // 128)) < 0.7).astype(np.int32)).to(cuda)
    for a, b in zip(K.ray_mask_hier(act_t, sup, box, bundle),
                    K.ray_mask_hier_plain(act_t, sup, box, bundle)):
        assert torch.equal(a, b)


def _mask_inputs(rng, nt, c, cuda):
    """(act, box, bundle) of a mask call on the card: random rays with zero
    direction components and inactive rays, tiles 3 and 10 (when there)
    without an active ray, random boxes with every fifth one empty."""
    import numpy as np

    from raytracer_tpu_torch.ops import cluster_trace as pct
    from raytracer_tpu_torch.ops import kernels as K

    r = nt * K.TILE
    o = rng.uniform(-2, 2, (r, 3)).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d[::7, 1] = 0.0
    act = rng.random(r) < 0.8
    act[3 * K.TILE:4 * K.TILE] = act[10 * K.TILE:11 * K.TILE] = False
    thi = rng.uniform(0.5, 4.0, r).astype(np.float32)
    cmin = rng.uniform(-3, 2, (c, 3)).astype(np.float32)
    cmax = (cmin + rng.uniform(0.05, 1.5, (c, 3))).astype(np.float32)
    cmin[1::5] = cmax[1::5] = np.nan
    on = lambda x: torch.from_numpy(x).to(cuda)  # noqa: E731
    act_t, bundle = pct._mask_bundle(on(o), on(d), on(act), on(thi), K.TILE)
    return act_t, pct._box_table(on(cmin), on(cmax)), bundle


@pytest.mark.parametrize("c", [513, 700, 4096, 4224])
@pytest.mark.parametrize("nt", [1, 64, 4096])
def test_ray_mask_hier_equals_plain_on_card(cuda, nt, c):
    """The hierarchical mask on random coarse bits, at launch sizes from
    one tile to a frame's chunk and at column counts with a partial last
    chunk (513, 700: rows not 16-byte aligned) and whole ones (4096,
    4224): equal to its plain version on the card, with as many chunks a
    block as ``backend.mask_hier_group`` says the launch takes."""
    import numpy as np

    from raytracer_tpu_torch import backend
    from raytracer_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(nt * 10007 + c)
    act, box, bundle = _mask_inputs(rng, nt, c, cuda)
    s = -(-c // 128)
    assert 1 <= backend.mask_hier_group(nt, c) <= s
    sup = torch.from_numpy((rng.random(nt * s) < 0.3).astype(np.int32)).to(cuda)
    sup[:s] = 1                                   # one tile with every chunk live
    for a, b in zip(K.ray_mask_hier(act, sup, box, bundle),
                    K.ray_mask_hier_plain(act, sup, box, bundle)):
        assert torch.equal(a, b)


def test_hier_case_equals_plain_on_card(cuda):
    """The hierarchical-mask case (tests/torch_hier_case.py: a tile that
    crosses every supercluster, tiles that cross one or none, an inactive
    tile whose coarse bits are set, a partial last chunk, empty clusters,
    zero direction components): the kernel equals its plain version on
    the card, and with the coarse bits of the port's route it equals the
    flat kernel."""
    import numpy as np

    from raytracer_tpu_torch.ops import cluster_trace as pct
    from raytracer_tpu_torch.ops import kernels as K
    from torch_hier_case import hier_case

    c = hier_case()
    on = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(cuda)  # noqa: E731
    act, bundle = pct._mask_bundle(on(c["origin"]), on(c["dirs"]), on(c["active"]),
                                   on(c["t_hi"]), K.TILE)
    box = pct._box_table(on(c["cmin"]), on(c["cmax"]))
    for sup in (on(c["sup"]), on(c["live"].astype(np.int32).reshape(-1))):
        got = K.ray_mask_hier(act, sup, box, bundle)
        for a, b in zip(got, K.ray_mask_hier_plain(act, sup, box, bundle)):
            assert torch.equal(a, b)
    for a, b in zip(got, K.ray_mask(act, box, bundle)):
        assert torch.equal(a, b)


def _compact_inputs(rng, nt, c, density, offset):
    """(hit, entry) (nt, offset + c + 3): random hits at ``density``; tile 0
    all hit (full, overflowing), tile 1 empty, tile 2 one hit; entries
    integer-valued in even tiles (heavy ties), normal in odd ones, tile 3
    a row of random -0 and +0."""
    import numpy as np

    width = offset + c + 3
    hit = rng.random((nt, width)) < density
    hit[0] = True
    hit[1] = False
    hit[2] = False
    hit[2, offset + c // 2] = c > 0
    entry = rng.normal(size=(nt, width)).astype(np.float32)
    entry[::2] = rng.integers(0, 5, (-(-nt // 2), width))
    entry[3] = np.where(rng.random(width) < 0.5, -0.0, 0.0)
    return hit, entry


@pytest.mark.parametrize("density", [0.01, 0.3, 1.0])
@pytest.mark.parametrize("max_list", [8, 48])
@pytest.mark.parametrize("c", [0, 1, 6, 37, 247, 256, 650, 4096, 4099])
def test_compact_equals_plain_on_card(cuda, c, max_list, density):
    """The compaction kernel against its plain version (on the CPU: the
    stable sort that orders -0 and +0 as equal) on a contiguous mask and on
    its column slice of a wider one, read in place (rows off 16-byte
    boundaries): words and counts everywhere, ids and entries (bit for
    bit) below min(count, max_list)."""
    import numpy as np

    from raytracer_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(c * 7 + max_list + int(density * 100))
    nt = 64
    hit, entry = _compact_inputs(rng, nt, c, density, 13)
    h, e = torch.from_numpy(hit).to(cuda), torch.from_numpy(entry).to(cuda)
    for offset, contiguous in ((0, True), (13, False)):
        th = h[:, offset:offset + c]
        te = e[:, offset:offset + c]
        if contiguous:
            th, te = th.contiguous(), te.contiguous()
        before = K.launches["compact"]
        got = K.compact(th, te, max_list)
        assert K.launches["compact"] == before + 1
        want = K.compact_plain(th.cpu(), te.cpu(), max_list)
        words, ids, elist, counts = (x.cpu() for x in got)
        what = f"C={c} max_list={max_list} offset={offset}"
        assert torch.equal(words, want[0]), what + ": words"
        assert torch.equal(counts, want[3]), what + ": counts"
        keep = (torch.arange(max_list)[None]
                < torch.clamp(counts, max=max_list)[:, None]).reshape(-1)
        assert torch.equal(ids[keep], want[1][keep]), what + ": ids"
        assert torch.equal(elist[keep].view(torch.int32),
                           want[2][keep].view(torch.int32)), what + ": entries"
        assert int(counts[0]) == c and int(counts[1]) == 0


@pytest.mark.parametrize("max_list", [8, 48])
@pytest.mark.parametrize("c", [0, 6, 519, 4099])
def test_compact_tally_equals_plain_on_card(cuda, c, max_list):
    """The compaction kernel's optional tally (the counters of the
    hierarchical route's shortlists): [tiles with a hit column, tiles past
    max_list] added to what the tally held, as the plain version adds them,
    on a contiguous mask and on a slice read in place; the outputs equal
    those of a call without a tally."""
    import numpy as np

    from raytracer_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(c + max_list)
    hit, entry = _compact_inputs(rng, 256, c, 0.05, 13)
    h, e = torch.from_numpy(hit).to(cuda), torch.from_numpy(entry).to(cuda)
    for th, te in ((h[:, 13:13 + c].contiguous(), e[:, 13:13 + c].contiguous()),
                   (h[:, 13:13 + c], e[:, 13:13 + c])):
        tally = torch.tensor([5, 7], dtype=torch.int64, device=cuda)
        got = K.compact(th, te, max_list, tally)
        want = torch.tensor([5, 7], dtype=torch.int64)
        K.compact_plain(th.cpu(), te.cpu(), max_list, want)
        assert torch.equal(tally.cpu(), want), (c, max_list)
        counts = got[3].cpu()
        assert int(want[0]) - 5 == int((counts > 0).sum())
        assert int(want[1]) - 7 == int((counts > max_list).sum())
        for a, b in zip(got, K.compact(th, te, max_list)):
            assert torch.equal(a, b)


def _compact_scene(name, cuda):
    from torch_port_util import epilogue_scene

    from raytracer_tpu_torch.utils import synth

    if name == "terrain2sph":
        return epilogue_scene(name, cuda)
    if name == "spheres":
        return synth.sphere_field(n_spheres=600, res=64, device=cuda)
    return synth.terrain_scene(cells=40, res=64, mirror_stripes=True,
                               device=cuda)


@pytest.mark.parametrize("scene", ["terrain2sph", "terrain_hier", "spheres"])
def test_compact_frames_equal_sort_route_on_card(cuda, scene, monkeypatch):
    """Replayed 64x64 frames with the compaction kernel equal the same
    frames with the compaction by the plain version's sort on the card:
    two small spheres and two lights (an empty sphere side, as the horse
    frame has), the terrain on the hierarchical mask, and a sphere field
    (the triangle and sphere slices of one concatenated mask).  The
    replayed frame launches the kernel once for each compaction of the
    eager frame's shortlists."""
    import numpy as np

    from raytracer_tpu_torch.models import programs
    from raytracer_tpu_torch.models.bvh import build_bvh
    from raytracer_tpu_torch.models.clusters import build_clusters
    from raytracer_tpu_torch.models.whitted import eager, render_camera
    from raytracer_tpu_torch.ops import cluster_trace as ctr
    from raytracer_tpu_torch.ops import kernels as K

    if scene == "terrain_hier":
        monkeypatch.setattr(ctr, "SUPER_MIN_CPAD", 0)
    data, meta = _compact_scene(scene, cuda)
    cset = build_clusters(data, meta, build_bvh(data, meta))
    cam = meta.cameras[0]

    def replayed():
        programs.drop(data)
        render_camera(data, meta, cam, cset, device=cuda)    # captures
        K.reset_launches()
        img = render_camera(data, meta, cam, cset, device=cuda)
        torch.cuda.synchronize()
        return img.cpu(), dict(K.launches)

    compact = ctr._compact
    with monkeypatch.context() as m:
        m.setattr(ctr, "_compact", K.compact_plain)
        want, sort_launches = replayed()
    got, launches = replayed()
    assert sort_launches["compact"] == 0
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    calls = []

    def counted(*a):
        calls.append(a[0].is_contiguous())
        return compact(*a)

    with monkeypatch.context() as m, eager():
        m.setattr(ctr, "_compact", counted)
        K.reset_launches()
        render_camera(data, meta, cam, cset, device=cuda)
    assert calls and launches["compact"] == len(calls) == K.launches["compact"]
    assert all(calls) == (scene != "spheres")     # slices read in place
    programs.drop(data)


def _tile_mask_inputs(rng, nt, c, shared, active, t_hi):
    """Eye-like rays of ``nt`` tiles (origin, dirs, active, t_hi) and ``c``
    cluster boxes (cmin, cmax), numpy float32.  Each tile's directions
    jitter about their own axis: tile 1's x component is exactly 0 (its
    rays' signs mixed), tile 2's y -0.0, tile 3's z crosses zero; every
    7th box is NaN.  ``active``: None, "partial" (90% of the rays) or
    "tiles" (partial, and tiles 0, 5, 6 wholly inactive)."""
    import numpy as np

    r = nt * 128
    axis = rng.normal(size=(nt, 1, 3)) * [0.4, 0.3, 0.2] + [0.0, -0.4, -1.0]
    d = (axis + rng.normal(size=(nt, 128, 3)) * 0.01).astype(np.float32)
    if nt > 3:
        d[1, :, 0] = np.where(rng.random(128) < 0.5, -0.0, 0.0)
        d[2, :, 1] = -0.0
        d[3, :, 2] = np.linspace(-0.01, 0.01, 128)
    d = d.reshape(r, 3)
    if shared:
        o = np.broadcast_to(np.float32([0.5, 30.0, 60.0]), (r, 3)).copy()
    else:
        o = (rng.normal(size=(r, 3)) * 20.0 + [0.0, 10.0, 0.0]).astype(np.float32)
    act = None
    if active is not None:
        act = rng.random(r) < 0.9
        if active == "tiles":
            for t in (0, 5, 6):
                act[t * 128:(t + 1) * 128] = False
    th = None if not t_hi else rng.uniform(10.0, 120.0, r).astype(np.float32)
    cmin = rng.uniform(-60.0, 60.0, (c, 3)).astype(np.float32)
    cmin[:, 1] = rng.uniform(-5.0, 25.0, c)
    cmax = (cmin + rng.uniform(0.5, 12.0, (c, 3))).astype(np.float32)
    cmin[3::7] = cmax[3::7] = np.nan
    return o, d, act, th, cmin, cmax


_TILE_MASK_CASES = (
    [(c, nt, 1) for c in (1, 6, 247, 4096, 4099) for nt in (1, 1024, 32400)]
    + [(c, nt, s) for c in (6, 247, 4099) for nt in (1, 1024) for s in (2, 4)])


@pytest.mark.parametrize("c,nt,subsplit", _TILE_MASK_CASES)
def test_tile_mask_equals_plain_on_card(cuda, c, nt, subsplit):
    """The interval tile mask kernel against its plain version on the card,
    both active-mask forms and none, with and without a t window, a shared
    and a per-ray origin, NaN boxes and zero direction components: hit
    equal everywhere, entry equal everywhere (NaN at the same places; a
    zero's sign is free), one launch a call."""
    import numpy as np

    from raytracer_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(c * 31 + nt + subsplit)
    for shared, active, t_hi in ((True, None, False), (False, "partial", True),
                                 (True, "tiles", False), (False, "tiles", True),
                                 (True, None, True)):
        arrays = _tile_mask_inputs(rng, nt, c, shared, active, t_hi)
        o, d, act, th, cmin, cmax = (
            None if x is None else torch.from_numpy(x).to(cuda) for x in arrays)
        before = K.launches["tile_mask"]
        hit, entry = K.tile_mask(o, d, act, cmin, cmax, th, 128, subsplit)
        assert K.launches["tile_mask"] == before + 1
        want_h, want_e = [], []
        step = max(1, (1 << 22) // (c * subsplit))   # tiles a plain call
        for a in range(0, nt, step):
            rows = slice(a * 128, min(nt, a + step) * 128)
            ph, pe = K.tile_mask_plain(
                o[rows], d[rows], None if act is None else act[rows], cmin,
                cmax, None if th is None else th[rows], 128, subsplit)
            want_h.append(ph)
            want_e.append(pe)
        want_h, want_e = torch.cat(want_h), torch.cat(want_e)
        what = (f"C={c} nt={nt} subsplit={subsplit} shared={shared} "
                f"active={active} t_hi={t_hi}")
        assert torch.equal(hit, want_h), what + ": hit"
        assert torch.equal(torch.isnan(entry), torch.isnan(want_e)), what + ": NaN"
        assert bool(((entry == want_e) | torch.isnan(want_e)).all()), what + ": entry"
        if active == "tiles":
            assert not hit[0].any(), what
        if nt >= 1024 and c >= 247:
            assert hit.any() and not hit.all(), what
    with pytest.raises(ValueError):
        K.tile_mask(o[:-1], d[:-1], None, cmin, cmax, None, 128, subsplit)
    with pytest.raises(ValueError):
        K.tile_mask(o, d.double(), None, cmin, cmax, None, 128, subsplit)


@pytest.mark.parametrize("scene,chunk,per_frame", [("terrain_hier", 128, 32),
                                                   ("terrain2sph", 1 << 22, 1)])
def test_tile_mask_frames_equal_plain_on_card(cuda, scene, chunk, per_frame,
                                              monkeypatch):
    """Replayed 64x64 frames with the interval tile mask kernel equal, bit
    for bit, the same frames with ``tile_cluster_mask`` on its plain
    version: the terrain on the hierarchical mask in 32 wavefronts of one
    tile (as the big frame's 32 bands) and two small spheres with two
    lights in one (as the horse frame).  The replayed frame launches the
    kernel once a wavefront, the plain route never."""
    import numpy as np

    from raytracer_tpu_torch.models import programs
    from raytracer_tpu_torch.models.bvh import build_bvh
    from raytracer_tpu_torch.models.clusters import build_clusters
    from raytracer_tpu_torch.models.whitted import render_camera
    from raytracer_tpu_torch.ops import cluster_trace as ctr
    from raytracer_tpu_torch.ops import kernels as K

    if scene == "terrain_hier":
        monkeypatch.setattr(ctr, "SUPER_MIN_CPAD", 0)
    data, meta = _compact_scene(scene, cuda)
    cset = build_clusters(data, meta, build_bvh(data, meta))
    cam = meta.cameras[0]

    def replayed():
        programs.drop(data)
        render_camera(data, meta, cam, cset, chunk=chunk, device=cuda)
        K.reset_launches()
        img = render_camera(data, meta, cam, cset, chunk=chunk, device=cuda)
        torch.cuda.synchronize()
        return img.cpu(), dict(K.launches)

    with monkeypatch.context() as m:
        m.setattr(ctr, "tile_cluster_mask", K.tile_mask_plain)
        want, plain_launches = replayed()
    got, launches = replayed()
    assert plain_launches["tile_mask"] == 0
    assert launches["tile_mask"] == per_frame
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    programs.drop(data)


def _terrain_both(cuda):
    """(meta, camera, CPU (data, cset), CUDA (data, cset)) of one terrain."""
    from raytracer_tpu_torch.models.bvh import build_bvh
    from raytracer_tpu_torch.models.clusters import build_clusters
    from raytracer_tpu_torch.utils import synth

    data, meta = synth.terrain_scene(cells=40, res=64, mirror_stripes=True,
                                     device="cpu")
    cset = build_clusters(data, meta, build_bvh(data, meta))
    return meta, meta.cameras[0], (data, cset), (data.to(cuda), cset.to(cuda))


@pytest.mark.parametrize("ssaa,mode", [(2, "parity"), (4, "parity"), (2, "jitter")])
def test_streamed_cuda_equals_cpu(cuda, ssaa, mode):
    """The band renderer on the card (4 bands and more) against the CPU with
    the same jitter: at most 4 pixels > 1 LSB (the repo's engine bar)."""
    from raytracer_tpu_torch.models.whitted import render_camera_streamed
    from raytracer_tpu_torch.ops.camera import recorded_jitter

    meta, cam, (cd, cc), (gd, gc) = _terrain_both(cuda)
    record, replay = recorded_jitter(3, cuda)
    kw = dict(ssaa=ssaa, ssaa_mode=mode, chunk=cam.width * ssaa * 16)
    got = render_camera_streamed(gd, meta, cam, gc, device=cuda, jitter=record, **kw)
    want = render_camera_streamed(cd, meta, cam, cc, device="cpu", jitter=replay, **kw)
    d = (got.cpu().int() - want.int()).abs().amax(-1)
    assert got.shape == want.shape == (cam.height, cam.width, 3)
    assert int((d > 1).sum()) <= 4


@pytest.mark.parametrize("rounds", [1, 2])
def test_adaptive_cuda_equals_cpu(cuda, rounds):
    """Adaptive sampling on the card against the CPU with the same draws:
    the same stats and at most 4 pixels > 1 LSB after quantization."""
    from raytracer_tpu_torch.ops.adaptive import render_camera_adaptive
    from raytracer_tpu_torch.ops.camera import recorded_jitter
    from raytracer_tpu_torch.ops.image import quantize

    meta, cam, (cd, cc), (gd, gc) = _terrain_both(cuda)
    record, replay = recorded_jitter(5, cuda)
    kw = dict(rounds=rounds, refine_frac=0.25)
    got, gs = render_camera_adaptive(gd, meta, cam, gc, device=cuda, jitter=record, **kw)
    want, ws = render_camera_adaptive(cd, meta, cam, cc, device="cpu", jitter=replay,
                                      **kw)
    assert gs == ws
    d = (quantize(got).cpu().int() - quantize(want).int()).abs().amax(-1)
    assert int((d > 1).sum()) <= 4


@pytest.mark.parametrize("seed,key,shape", [(7, ("band", 48), (48, 512, 2)),
                                            (2**40 + 3, ("base", 0), (64, 4, 128, 2)),
                                            (3, ("round", 1), (5, 7, 2))])
def test_jitter_draws_on_card_equal_cpu(cuda, seed, key, shape):
    """The threefry kernel's draw on the card equals the plain version's on
    the CPU bit for bit (one launch), so one seed renders one image on
    either device."""
    from raytracer_tpu_torch.ops import kernels as K
    from raytracer_tpu_torch.ops.camera import draw_jitter

    K.reset_launches()
    got = draw_jitter(None, seed, key, shape, cuda)
    torch.cuda.synchronize()
    assert K.launches["threefry"] == 1
    assert got.device.type == "cuda" and got.shape == shape
    want = draw_jitter(None, seed, key, shape, "cpu")
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("seed,key,shape", [(7, ("band", 48), (48, 512, 2)),
                                            (2**40 + 3, ("base", 0), (64, 4, 128, 2)),
                                            (3, ("round", 1), (5, 7, 2))])
def test_keyed_draw_on_card_equals_plain_and_host_key(cuda, seed, key, shape):
    """The threefry kernel with its key read from device memory
    (``threefry_uniform_keyed``, into a given buffer) equals its plain
    version on the same key tensor and the host-key call on the same key
    bit for bit: one launch each for the keyed and host-key calls."""
    import math

    from raytracer_tpu_torch.ops import kernels as K
    from raytracer_tpu_torch.ops.camera import jitter_key

    words = jitter_key(seed, key)
    key_t = torch.tensor(words, dtype=torch.int64, device=cuda)
    K.reset_launches()
    out = torch.full(shape, float("nan"), device=cuda)
    got = K.threefry_uniform_keyed(key_t, out, -0.5, 0.5)
    host = K.threefry_uniform(*words, math.prod(shape), -0.5, 0.5, cuda)
    plain = K.threefry_uniform_keyed_plain(key_t, torch.empty(shape, device=cuda),
                                           -0.5, 0.5)
    torch.cuda.synchronize()
    assert got is out and K.launches["threefry"] == 2
    for x in (host, plain):
        assert torch.equal(got.view(-1).view(torch.int32),
                           x.reshape(-1).view(torch.int32))


def test_replayed_jitter_bands_equal_eager_on_card(cuda):
    """A jittered 64x64 camera at --ssaa 2 in 4 bands of 32 rows, its band
    program drawing in its prologue under the key written before each
    replay: eager, captured, replayed, eager equal bit for bit with equal
    launches (4 draws a frame); then other bands' key words written into
    the captured program and its prologue replayed alone: the plain
    version's draw of each key."""
    from raytracer_tpu_torch.models import programs
    from raytracer_tpu_torch.models.bvh import build_bvh
    from raytracer_tpu_torch.models.clusters import build_clusters
    from raytracer_tpu_torch.models.whitted import eager, render_camera_streamed
    from raytracer_tpu_torch.ops import kernels as K
    from raytracer_tpu_torch.ops.camera import jitter_key, write_jitter_keys
    from raytracer_tpu_torch.utils import synth

    data, meta = synth.terrain_scene(cells=16, res=64, mirror_stripes=True,
                                     device=cuda)
    cset = build_clusters(data, meta, build_bvh(data, meta))
    cam = meta.cameras[0]
    kw = dict(ssaa=2, ssaa_mode="jitter", seed=9, chunk=128 * 32, device=cuda)
    out = []
    for graphs in (False, True, True, False):
        with contextlib.nullcontext() if graphs else eager():
            K.reset_launches()
            img = render_camera_streamed(data, meta, cam, cset, **kw)
            torch.cuda.synchronize()
            out.append((img.cpu(), dict(K.launches)))
    for img, launches in out[1:]:
        assert torch.equal(img, out[0][0]) and launches == out[0][1]
    assert out[0][1]["threefry"] == 4
    progs = programs.scene_programs(data, meta, cset, cuda)
    [frame] = [f for k, f in progs.items() if k[0] == "frame" and k[9] == "drawn"]
    assert frame.prologue.graph is not None
    for seed, row0 in ((9, 96), (2**32 - 1, 32), (9, 0)):
        write_jitter_keys(frame.key_words, seed, [("band", row0)])
        frame.prologue()
        want = K.threefry_uniform_plain(*jitter_key(seed, ("band", row0)),
                                        frame.jitter.numel(), -0.5, 0.5)
        torch.cuda.synchronize()
        assert torch.equal(frame.jitter.cpu().view(-1).view(torch.int32),
                           want.view(torch.int32)), (seed, row0)
    programs.drop(data)


def _train_step_both(cuda, engine, fields=("mat_diffuse", "light_int")):
    """One make_train_step on the card and on the CPU from the same
    perturbed terrain at 32x32 (target: the true radiance, rendered on
    the CPU): ((loss, grads) on the card, (loss, grads) on the CPU)."""
    from raytracer_tpu_torch.models.bvh import build_bvh, device_bvh
    from raytracer_tpu_torch.models.clusters import build_clusters
    from raytracer_tpu_torch.models.whitted import render_rays
    from raytracer_tpu_torch.ops.camera import camera_vectors, eye_rays_from
    from raytracer_tpu_torch.parallel.train import init_state, make_train_step
    from raytracer_tpu_torch.utils import synth

    data, meta = synth.terrain_scene(cells=12, res=32, mirror_stripes=True,
                                     device="cpu")
    bvh = build_bvh(data, meta, ordered=engine == "bvh")
    accel = {"brute": None, "bvh": device_bvh(bvh, "cpu"),
             "cluster": build_clusters(data, meta, bvh)}[engine]
    cam = meta.cameras[0]
    origin, dirs = eye_rays_from(torch.from_numpy(camera_vectors(cam)),
                                 cam.width, cam.height)
    with torch.no_grad():
        target = render_rays(data, meta, origin, dirs, accel, engine=engine)
    bad = dataclasses.replace(data, mat_diffuse=data.mat_diffuse * 0.5,
                              light_int=data.light_int * 0.7)
    out = []
    for dev in (cuda, torch.device("cpu")):
        d = bad.to(dev)
        acc = None if accel is None else accel.to(dev)
        state = init_state(d, fields=fields)
        step = make_train_step(meta, engine=engine, device=dev)
        state, loss = step(state, d, origin.to(dev), dirs.to(dev),
                           target.to(dev), accel=acc)
        out.append((float(loss), {f: p.grad.cpu() for f, p in
                                  state.params.items()}))
    return out


@pytest.mark.parametrize("engine", ["brute", "bvh", "cluster"])
def test_train_step_cuda_equals_cpu(cuda, engine):
    """One training step on the card against the CPU: the loss to rtol
    1e-5, each field's gradient within 1e-3 of its max |g| (the material
    gathers' backward sums in another order on the card)."""
    (gl, gg), (cl, cg) = _train_step_both(cuda, engine,
                                          fields=("mat_diffuse", "light_int",
                                                  "vertices"))
    assert abs(gl - cl) <= 1e-5 * abs(cl)
    for f, want in cg.items():
        assert torch.isfinite(gg[f]).all(), f
        assert float((gg[f] - want).abs().max()) <= 1e-3 * float(want.abs().max()), f


@pytest.mark.parametrize("engine", ["brute", "bvh"])
def test_brute_bvh_cuda_equal_cpu(cuda, engine):
    """The brute and BVH engines on the card: prim ids and occlusion bits
    equal the CPU's on random rays, and a rendered image meets the image
    bar against the CPU's."""
    import numpy as np

    from raytracer_tpu_torch.models.bvh import build_bvh, device_bvh
    from raytracer_tpu_torch.models.whitted import render_camera
    from raytracer_tpu_torch.ops import traverse as PT
    from raytracer_tpu_torch.ops.image import quantize

    meta, cam, (cd, _), (gd, _) = _terrain_both(cuda)
    bvh = build_bvh(cd, meta, ordered=True)
    accel = {"cpu": None, "cuda": None}
    if engine == "bvh":
        accel = {"cpu": device_bvh(bvh, "cpu"), "cuda": device_bvh(bvh, cuda)}
    rng = np.random.default_rng(0)
    o = torch.from_numpy(rng.uniform(-50, 50, (4096, 3)).astype(np.float32))
    o[:, 1] = 40.0
    d = torch.from_numpy(rng.normal(size=(4096, 3)).astype(np.float32))
    d[:, 1] = -torch.abs(d[:, 1]) - 0.2
    t_max = torch.from_numpy(rng.uniform(0.5, 80, 4096).astype(np.float32))
    res = {}
    for key, data in (("cpu", cd), ("cuda", gd)):
        dev = data.device
        p = PT.closest_hit(data, o.to(dev), d.to(dev), accel[key], engine)
        a = PT.any_hit(data, o.to(dev), d.to(dev), t_max.to(dev), accel[key],
                       engine)
        img = quantize(render_camera(data, meta, cam, accel[key], device=dev,
                                     engine=engine))
        res[key] = (p.cpu(), a.cpu(), img.cpu())
    assert float((res["cpu"][0] >= 0).float().mean()) > 0.3
    assert torch.equal(res["cuda"][0], res["cpu"][0])
    assert torch.equal(res["cuda"][1], res["cpu"][1])
    dd = (res["cuda"][2].int() - res["cpu"][2].int()).abs().amax(-1)
    assert int((dd > 1).sum()) <= 4


def test_train_step_kernels_equal_plain_on_card(cuda):
    """The cluster engine's training step on the card: every kernel call
    it makes (the flat mask, the per-ray-origin closest hit, the 2-light
    shadow, once a bounce; no shared-origin closest) equals its plain
    version.  The step runs under eager(): a replayed step calls no
    wrapper, and its capture calls them on tensors it does not compute."""
    from raytracer_tpu_torch.models.whitted import eager
    from raytracer_tpu_torch.ops import kernels as K

    calls = []
    names = ("ray_mask", "closest", "shadow")
    wrapped = {n: getattr(K, n) for n in names}

    def spy(name):
        def f(*a):
            calls.append((name, a))
            return wrapped[name](*a)
        return f

    for n in names:
        setattr(K, n, spy(n))
    try:
        with eager():
            _train_step_both(cuda, "cluster")
    finally:
        for n, f in wrapped.items():
            setattr(K, n, f)
    on_card = [(n, a) for n, a in calls if a[0].device.type == "cuda"]
    assert {n for n, _ in on_card} == set(names)
    # one multi-light launch per bounce (max depth 2), never one per light
    shadows = [a for n, a in on_card if n == "shadow"]
    assert len(shadows) == 3 and all(a[8].shape[0] == 2 for a in shadows)
    for name, args in on_card:
        if name == "closest":
            assert args[6].dim() == 2, "a shared-origin closest call"
        out_k = wrapped[name](*args)
        out_p = getattr(K, name + "_plain")(*args)
        out_k = out_k if isinstance(out_k, tuple) else (out_k,)
        out_p = out_p if isinstance(out_p, tuple) else (out_p,)
        for a, b in zip(out_k, out_p):
            assert torch.equal(a, b), name


@pytest.mark.parametrize("height,ssaa", [(64, 2), (150, 1)])
def test_mesh_frame_equals_single_device_on_card(cuda, height, ssaa):
    """A 2-shard mesh of one card (logical shards) renders the terrain bit
    for bit as one device does, at --ssaa 2 and at 150 rows (the last band
    padded with virtual rows), launching the kernels on the card."""
    import numpy as np

    from raytracer_tpu_torch.models.bvh import build_bvh
    from raytracer_tpu_torch.models.clusters import build_clusters
    from raytracer_tpu_torch.ops import kernels as K
    from raytracer_tpu_torch.parallel.mesh import make_mesh
    from raytracer_tpu_torch.pipeline import render_one_camera
    from raytracer_tpu_torch.utils import synth

    data, meta = synth.terrain_scene(cells=40, res=64, mirror_stripes=True,
                                     device=cuda)
    cset = build_clusters(data, meta, build_bvh(data, meta))
    cam = dataclasses.replace(meta.cameras[0], width=64 * (1 + (height > 64)),
                              height=height)
    single, _ = render_one_camera(data, meta, cam, cset, ssaa=ssaa, device=cuda)
    K.reset_launches()
    mesh = make_mesh(devices=[cuda, cuda])
    sharded, _ = render_one_camera(data, meta, cam, cset, ssaa=ssaa,
                                   device=cuda, mesh=mesh)
    assert K.launches["closest_shared"] == 2 and K.launches["shadow"] > 0
    np.testing.assert_array_equal(sharded, single)


def test_mesh_train_step_equals_single_device_on_card(cuda):
    """A training step on a 2-shard mesh of one card against one device:
    the loss to rtol 1e-5, each gradient within 1e-3 of its max |g|."""
    from raytracer_tpu_torch.models.bvh import build_bvh
    from raytracer_tpu_torch.models.clusters import build_clusters
    from raytracer_tpu_torch.models.whitted import render_rays
    from raytracer_tpu_torch.ops.camera import camera_vectors, eye_rays_from
    from raytracer_tpu_torch.parallel.mesh import make_mesh
    from raytracer_tpu_torch.parallel.train import init_state, make_train_step
    from raytracer_tpu_torch.utils import synth

    data, meta = synth.terrain_scene(cells=12, res=32, mirror_stripes=True,
                                     device=cuda)
    cset = build_clusters(data, meta, build_bvh(data, meta))
    cam = meta.cameras[0]
    origin, dirs = eye_rays_from(torch.from_numpy(camera_vectors(cam)).to(cuda),
                                 cam.width, cam.height)
    with torch.no_grad():
        target = render_rays(data, meta, origin, dirs, cset, engine="cluster")
    bad = dataclasses.replace(data, mat_diffuse=data.mat_diffuse * 0.5,
                              light_int=data.light_int * 0.7)
    got = []
    for mesh in (None, make_mesh(devices=[cuda, cuda])):
        state = init_state(bad, fields=("mat_diffuse", "light_int", "vertices"))
        step = make_train_step(meta, engine="cluster", device=cuda, mesh=mesh)
        state, loss = step(state, bad, origin, dirs, target, accel=cset)
        got.append((float(loss), {f: p.grad for f, p in state.params.items()}))
    (l1, g1), (l2, g2) = got
    assert abs(l2 - l1) <= 1e-5 * abs(l1)
    for f, want in g1.items():
        assert torch.isfinite(g2[f]).all(), f
        assert float((g2[f] - want).abs().max()) <= 1e-3 * float(want.abs().max()), f


def test_served_frame_kernels_equal_plain_on_card(cuda, tmp_path):
    """A request to the render server on the card (the entry scene at
    --ssaa 2): its image is render_one_camera's, and every kernel call it
    makes equals its plain version."""
    import os

    import numpy as np

    from raytracer_tpu_torch.models.bvh import build_bvh
    from raytracer_tpu_torch.models.clusters import build_clusters
    from raytracer_tpu_torch.models.scene import load_scene
    from raytracer_tpu_torch.models.whitted import eager
    from raytracer_tpu_torch.pipeline import render_one_camera
    from raytracer_tpu_torch.serve import RenderServer
    from raytracer_tpu_torch.utils.ppm import read_ppm

    xml = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "entry_scene.xml")
    from raytracer_tpu_torch.ops import kernels as K

    server = RenderServer(device=cuda)
    calls = []
    names = ("ray_mask", "closest", "shadow")
    wrapped = {n: getattr(K, n) for n in names}

    def spy(name):
        def f(*a):
            calls.append((name, a))
            return wrapped[name](*a)
        return f

    for n in names:
        setattr(K, n, spy(n))
    try:
        with eager():             # a replayed graph calls no wrapper
            r = server.handle({"scene": xml, "out_dir": str(tmp_path),
                               "ssaa": 2})
    finally:
        for n, f in wrapped.items():
            setattr(K, n, f)
    assert r["ok"], r
    assert {n for n, _ in calls} == set(names)
    _render_and_compare.calls = calls
    for name, args in calls:
        out_k = wrapped[name](*args)
        out_p = getattr(K, name + "_plain")(*args)
        out_k = out_k if isinstance(out_k, tuple) else (out_k,)
        out_p = out_p if isinstance(out_p, tuple) else (out_p,)
        for a, b in zip(out_k, out_p):
            assert torch.equal(a, b), name
    data, meta = load_scene(xml, device=cuda)
    cset = build_clusters(data, meta, build_bvh(data, meta))
    want, _ = render_one_camera(data, meta, meta.cameras[0], cset, ssaa=2,
                                device=cuda)
    np.testing.assert_array_equal(read_ppm(r["images"][0]), want)


@pytest.mark.parametrize("scene", ["entry", "terrain"])
@pytest.mark.parametrize("ssaa,mode", [(1, "parity"), (2, "jitter")])
def test_replayed_frames_equal_eager_on_card(cuda, scene, ssaa, mode):
    """The compiled programs (CUDA graphs of the cluster engine's steps)
    against the same bodies run eagerly, bit for bit: streamed frames of
    several bands of one shape (one capture, then replays with row0, the
    camera vector and the jitter copied in), render_camera, and the
    launch counts of a replayed frame equal to the eager frame's."""
    import contextlib
    import os

    import numpy as np

    from raytracer_tpu_torch.models import programs
    from raytracer_tpu_torch.models.bvh import build_bvh
    from raytracer_tpu_torch.models.clusters import build_clusters
    from raytracer_tpu_torch.models.scene import load_scene
    from raytracer_tpu_torch.models.whitted import (
        eager, render_camera, render_camera_streamed,
    )
    from raytracer_tpu_torch.ops import kernels as K
    from raytracer_tpu_torch.utils import synth

    if scene == "entry":
        xml = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                           "entry_scene.xml")
        data, meta = load_scene(xml, device=cuda)
    else:
        data, meta = synth.terrain_scene(cells=16, res=64, mirror_stripes=True,
                                         device=cuda)
    cset = build_clusters(data, meta, build_bvh(data, meta))
    cam = meta.cameras[0]
    kw = dict(ssaa=ssaa, ssaa_mode=mode, seed=4, device=cuda,
              chunk=cam.width * ssaa * 16)
    counts = []
    frames = []
    for graphs in (False, True, True, False):
        with contextlib.nullcontext() if graphs else eager():
            K.reset_launches()
            frames.append(render_camera_streamed(data, meta, cam, cset, **kw))
            torch.cuda.synchronize()
            counts.append(dict(K.launches))
            frames.append(render_camera(data, meta, cam, cset, device=cuda))
    assert programs.cached(data) > 0
    for k, f in enumerate(frames):
        np.testing.assert_array_equal(f.cpu().numpy(), frames[k % 2].cpu().numpy())
    assert counts[0] == counts[1] == counts[2] == counts[3]
    assert counts[0]["closest_shared"] == -(-cam.height * ssaa // 16)
    programs.drop(data)


def test_capture_of_host_sync_raises(cuda):
    """A step that reads a device value on the host cannot be captured: it
    raises, naming the step, and nothing falls back to eager."""
    from raytracer_tpu_torch.models import programs

    x = torch.ones(4, device=cuda)
    progs = programs.Programs((), (), programs.CudaGraph)
    step = progs.step("host read", lambda: bool(x.sum() > 0))
    with pytest.raises(RuntimeError, match="'host read' failed"):
        step()
    assert step.graph is None


def _train_problem(cuda, res=64):
    """(perturbed data, meta, clusters, origin, dirs, target) of the terrain
    through a res x res camera on the card, the target the true radiance."""
    from raytracer_tpu_torch.models.bvh import build_bvh
    from raytracer_tpu_torch.models.clusters import build_clusters
    from raytracer_tpu_torch.models.whitted import render_rays
    from raytracer_tpu_torch.ops.camera import camera_vectors, eye_rays_from
    from raytracer_tpu_torch.utils import synth

    data, meta = synth.terrain_scene(cells=16, res=res, mirror_stripes=True,
                                     device=cuda)
    cset = build_clusters(data, meta, build_bvh(data, meta))
    cam = meta.cameras[0]
    origin, dirs = eye_rays_from(torch.from_numpy(camera_vectors(cam)).to(cuda),
                                 cam.width, cam.height)
    with torch.no_grad():
        target = render_rays(data, meta, origin, dirs, cset, engine="cluster")
    bad = dataclasses.replace(data, mat_diffuse=data.mat_diffuse * 0.5,
                              light_int=data.light_int * 0.7)
    return bad, meta, cset, origin, dirs, target


def test_replayed_train_step_equals_eager_on_card(cuda):
    """The training step replayed (one capture, then CUDA graph replays)
    against the eager step on a 64x64 camera, under
    torch.use_deterministic_algorithms(True) (index_add_, the backward of
    the gathers, otherwise sums with float atomics): loss, gradients and
    parameters equal bit for bit after each of 3 steps, and the launch
    counts of each step equal (the flat mask, the per-ray-origin closest
    hit and the n-light shadow; no shared-origin closest hit)."""
    from raytracer_tpu_torch.models import programs
    from raytracer_tpu_torch.models.whitted import eager
    from raytracer_tpu_torch.ops import kernels as K
    from raytracer_tpu_torch.parallel.train import init_state, make_train_step

    bad, meta, cset, origin, dirs, target = _train_problem(cuda)
    fields = ("mat_diffuse", "light_int", "light_pos", "vertices")
    runs = []
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for graphs in (True, False):
            state = init_state(bad, fields=fields)
            step = make_train_step(meta, engine="cluster", device=cuda)
            c0 = programs.stats["captures"]
            got = []
            for _ in range(3):
                K.reset_launches()
                with contextlib.nullcontext() if graphs else eager():
                    state, loss = step(state, bad, origin, dirs, target,
                                       accel=cset)
                torch.cuda.synchronize()
                got.append((loss, {f: p.grad.clone() for f, p in
                                   state.params.items()},
                            {f: p.detach().clone() for f, p in
                             state.params.items()}, dict(K.launches)))
            assert programs.stats["captures"] == c0 + graphs
            runs.append(got)
    finally:
        torch.use_deterministic_algorithms(was)
    for i, (a, b) in enumerate(zip(*runs)):
        assert torch.equal(a[0], b[0]), f"step {i + 1} loss"
        for f in fields:
            assert torch.equal(a[1][f], b[1][f]), f"step {i + 1} {f} grad"
            assert torch.equal(a[2][f], b[2][f]), f"step {i + 1} {f} param"
        assert a[3] == b[3], f"step {i + 1} launches {a[3]} vs {b[3]}"
        assert a[3]["closest_shared"] == 0 and all(
            a[3][k] > 0 for k in ("ray_mask", "closest", "shadow"))


def test_replayed_adaptive_equals_eager_on_card(cuda):
    """The adaptive frame replayed (its program's CUDA graphs) against
    eager() on a 64x64 camera, 1 and 3 rounds: 0 differing pixels, equal
    stats and launches (the threefry draw included)."""
    from raytracer_tpu_torch.models import programs
    from raytracer_tpu_torch.models.bvh import build_bvh
    from raytracer_tpu_torch.models.clusters import build_clusters
    from raytracer_tpu_torch.models.whitted import eager
    from raytracer_tpu_torch.ops import kernels as K
    from raytracer_tpu_torch.ops.adaptive import render_camera_adaptive
    from raytracer_tpu_torch.utils import synth

    data, meta = synth.terrain_scene(cells=16, res=64, mirror_stripes=True,
                                     device=cuda)
    cset = build_clusters(data, meta, build_bvh(data, meta))
    cam = meta.cameras[0]
    for rounds in (1, 3):
        out = []
        for graphs in (False, True, True, False):
            with contextlib.nullcontext() if graphs else eager():
                K.reset_launches()
                img, stats = render_camera_adaptive(
                    data, meta, cam, cset, rounds=rounds, seed=2, device=cuda)
                torch.cuda.synchronize()
                out.append((img.cpu(), stats, dict(K.launches)))
        assert programs.cached(data) > 0
        for img, stats, launches in out[1:]:
            assert torch.equal(img, out[0][0]) and stats == out[0][1]
            assert launches == out[0][2]
        assert out[0][2]["threefry"] == 1 + rounds
    programs.drop(data)


@pytest.mark.parametrize("height,ssaa,mode", [
    (64, 2, "parity"), (64, 2, "jitter"), (150, 1, "parity")])
def test_replayed_mesh_band_equals_eager_on_card(cuda, height, ssaa, mode):
    """A band on a 2-shard mesh of one card replays as one program (the
    first frame captures, the second captures nothing) and equals the same
    frame eager (``eager()``) and the single-device render bit for bit,
    with equal launches: --ssaa 2 in parity and jitter, and 150 rows (the
    last band padded with virtual rows)."""
    import numpy as np

    from raytracer_tpu_torch.models import programs
    from raytracer_tpu_torch.models.bvh import build_bvh
    from raytracer_tpu_torch.models.clusters import build_clusters
    from raytracer_tpu_torch.models.whitted import eager
    from raytracer_tpu_torch.ops import kernels as K
    from raytracer_tpu_torch.parallel.mesh import make_mesh
    from raytracer_tpu_torch.pipeline import render_one_camera
    from raytracer_tpu_torch.utils import synth

    data, meta = synth.terrain_scene(cells=40, res=64, mirror_stripes=True,
                                     device=cuda)
    cset = build_clusters(data, meta, build_bvh(data, meta))
    cam = dataclasses.replace(meta.cameras[0], width=64 * (1 + (height > 64)),
                              height=height)
    mesh = make_mesh(devices=[cuda, cuda])
    kw = dict(ssaa=ssaa, ssaa_mode=mode, seed=4, device=cuda)
    single, _ = render_one_camera(data, meta, cam, cset, **kw)
    out = []
    for graphs in (False, True, True, False):
        with contextlib.nullcontext() if graphs else eager():
            c0 = programs.stats["captures"]
            K.reset_launches()
            img, _ = render_one_camera(data, meta, cam, cset, mesh=mesh, **kw)
            torch.cuda.synchronize()
            out.append((img, dict(K.launches),
                        programs.stats["captures"] - c0))
    assert [c for _, _, c in out] == [0, out[1][2], 0, 0] and out[1][2] > 0
    for img, launches, _ in out:
        np.testing.assert_array_equal(img, single)
        assert launches == out[0][1]
    assert out[0][1]["closest_shared"] == 2
    programs.drop(data)


def test_two_process_programs_on_card(tmp_path):
    """Two processes on the card (gloo, both on cuda:0) run the worker of
    tests/test_torch_mesh_programs.py with CUDA graphs: mesh frames
    replayed equal to eager and one device, the sharded wavefront, and the
    two-step train program against the eager multi-process step bit for
    bit over 3 steps under deterministic algorithms, its loss and gradient
    buffers the same across its replays, the ranks' steps equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from test_torch_mesh_programs import run_two_ranks

    run_two_ranks(tmp_path, "cuda", timeout=600)


def _engine_scene(cuda, engine):
    """(data, meta, accel) of the terrain (cells=16, 64x64 camera) on the
    card for ``engine``: the BVH with its octant threads, or None."""
    from raytracer_tpu_torch.models.bvh import build_bvh, device_bvh
    from raytracer_tpu_torch.utils import synth

    data, meta = synth.terrain_scene(cells=16, res=64, mirror_stripes=True,
                                     device=cuda)
    accel = (device_bvh(build_bvh(data, meta, ordered=True), cuda)
             if engine == "bvh" else None)
    return data, meta, accel


@pytest.mark.parametrize("engine", ["brute", "bvh"])
def test_replayed_engine_frames_equal_eager_on_card(cuda, engine):
    """The brute and BVH engines' frames replayed (CUDA graphs) against
    eager(): the camera's radiance, streamed --ssaa 2 parity and jitter,
    adaptive and a band on a 2-shard mesh of the card; eager, captured,
    replayed, eager: equal bit for bit, the same walk iterations, no
    kernel launched but the jitter draw, a capture only on the first graph
    run."""
    import numpy as np

    from raytracer_tpu_torch.models import programs
    from raytracer_tpu_torch.models.whitted import eager, render_camera
    from raytracer_tpu_torch.ops import kernels as K
    from raytracer_tpu_torch.ops.traverse import walk_stats
    from raytracer_tpu_torch.parallel.mesh import make_mesh
    from raytracer_tpu_torch.pipeline import render_one_camera

    data, meta, accel = _engine_scene(cuda, engine)
    cam = meta.cameras[0]
    mesh = make_mesh(devices=[cuda, cuda])
    frames = [lambda: render_camera(data, meta, cam, accel, device=cuda,
                                    engine=engine).cpu().numpy()]
    for kw in (dict(ssaa=2), dict(ssaa=2, ssaa_mode="jitter", seed=3),
               dict(ssaa=2, ssaa_mode="adaptive", seed=3),
               dict(ssaa=2, mesh=mesh)):
        frames.append(lambda kw=kw: render_one_camera(
            data, meta, cam, accel, device=cuda, engine=engine, **kw)[0])
    for frame in frames:
        out = []
        for graphs in (False, True, True, False):
            with contextlib.nullcontext() if graphs else eager():
                c0, w0 = programs.stats["captures"], walk_stats["iterations"]
                K.reset_launches()
                img = frame()
                torch.cuda.synchronize()
                out.append((img, programs.stats["captures"] - c0,
                            walk_stats["iterations"] - w0))
            # the jitter and adaptive frames' draws launch threefry
            assert not any(n for k, n in K.launches.items()
                           if k != "threefry"), dict(K.launches)
        assert [c for _, c, _ in out] == [0, out[1][1], 0, 0] and out[1][1] > 0
        for img, _, its in out:
            np.testing.assert_array_equal(img, out[0][0])
            assert its == out[0][2]
        assert (out[0][2] > 0) == (engine == "bvh")
    programs.drop(data)


@pytest.mark.parametrize("engine", ["brute", "bvh"])
def test_replayed_engine_step_equals_eager_on_card(cuda, engine):
    """The brute step (one graph) and the BVH step (its visibility pass's
    steps, then one graph) replayed against the eager step on a 64x64
    camera under torch.use_deterministic_algorithms(True): loss, gradients
    and parameters equal bit for bit after each of 3 steps."""
    from raytracer_tpu_torch.models import programs
    from raytracer_tpu_torch.models.whitted import eager, render_rays
    from raytracer_tpu_torch.ops.camera import camera_vectors, eye_rays_from
    from raytracer_tpu_torch.parallel.train import init_state, make_train_step

    data, meta, accel = _engine_scene(cuda, engine)
    cam = meta.cameras[0]
    origin, dirs = eye_rays_from(torch.from_numpy(camera_vectors(cam)).to(cuda),
                                 cam.width, cam.height)
    with torch.no_grad():
        target = render_rays(data, meta, origin, dirs, accel, engine=engine)
    bad = dataclasses.replace(data, mat_diffuse=data.mat_diffuse * 0.5,
                              light_int=data.light_int * 0.7)
    fields = ("mat_diffuse", "light_int", "light_pos", "vertices")
    runs = []
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for graphs in (True, False):
            state = init_state(bad, fields=fields)
            step = make_train_step(meta, engine=engine, device=cuda)
            c0 = programs.stats["captures"]
            got = []
            for _ in range(3):
                with contextlib.nullcontext() if graphs else eager():
                    state, loss = step(state, bad, origin, dirs, target,
                                       accel=accel)
                torch.cuda.synchronize()
                got.append((loss, {f: p.grad.clone() for f, p in
                                   state.params.items()},
                            {f: p.detach().clone() for f, p in
                             state.params.items()}))
            made = programs.stats["captures"] - c0
            assert (made > 1 if engine == "bvh" else made == 1) if graphs \
                else made == 0
            runs.append(got)
    finally:
        torch.use_deterministic_algorithms(was)
    for i, (a, b) in enumerate(zip(*runs)):
        assert torch.equal(a[0], b[0]), f"step {i + 1} loss"
        for f in fields:
            assert torch.equal(a[1][f], b[1][f]), f"step {i + 1} {f} grad"
            assert torch.equal(a[2][f], b[2][f]), f"step {i + 1} {f} param"
    assert all(bool(torch.isfinite(x[0])) for x in runs[0])


def test_two_process_bvh_programs_on_card(tmp_path):
    """The two-process worker of tests/test_torch_mesh_programs.py on the
    BVH engine with CUDA graphs: frames replayed equal to eager and one
    device, the sharded wavefront, and the two-step train program after
    each shard's visibility pass equal to the eager multi-process step
    over 3 steps under deterministic algorithms."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from test_torch_mesh_programs import run_two_ranks

    run_two_ranks(tmp_path, "cuda", timeout=600, engine="bvh")


def test_flag_spans_enclose_their_copies_on_card(cuda):
    """The port's spans share the profiler's clock on the card: each
    ``program.flags`` span of a profiled replayed frame (a terrain at max
    depth 3 that compacts) encloses the host event of its copy, and the
    wave counters sample every bounce the frame traced."""
    from torch.profiler import ProfilerActivity, profile

    from raytracer_tpu_torch import tracing
    from raytracer_tpu_torch.models import programs
    from raytracer_tpu_torch.models.bvh import build_bvh
    from raytracer_tpu_torch.models.clusters import build_clusters
    from raytracer_tpu_torch.pipeline import render_one_camera
    from raytracer_tpu_torch.utils import synth

    data, meta = synth.terrain_scene(cells=16, res=64, mirror_stripes=True,
                                     max_depth=3, device=cuda)
    cset = build_clusters(data, meta, build_bvh(data, meta))
    cam = meta.cameras[0]

    def frame():
        return render_one_camera(data, meta, cam, cset, ssaa=2,
                                 device=cuda)[0]

    want = frame()
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = frame()
    assert (got == want).all()
    copies = [(e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name() in ("cudaMemcpyAsync", "aten::_local_scalar_dense")]
    flags = [s for s in tracing.spans if s.name == "program.flags"]
    steps = [s for s in tracing.spans if s.name == "program.step"]
    assert flags and steps
    for s in flags:
        assert any(s.start <= a and b <= s.end for a, b in copies), s
    bounces = [s for s in steps if s.what.startswith("bounce")]
    active = [c for c in tracing.samples if c.name == "wave.active"]
    lanes = [c for c in tracing.samples if c.name == "wave.lanes"]
    assert len(active) == len(lanes) == len(bounces)
    assert active[0].value == lanes[0].value == (cam.width * 2) ** 2
    programs.drop(data)
