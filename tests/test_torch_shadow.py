"""The port's shadow kernel module (plain PyTorch version on the CPU)
against the JAX package's single-light (_shadow_kernel) and multi-light
(_shadow_kernel_ml) calls: occlusion bits equal on every active lane, with
``relaxed`` off and on and with back-face culling; the NaN-poison case of
tests/torch_poison_case.py bit for bit, and the plain version's
independence of the visit order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.ops import cluster_trace as jct
from raytracer_tpu_torch.ops import cluster_trace as pct
from raytracer_tpu_torch.ops import kernels as K
from torch_port_util import jax_accel, scene_rays, shared_inputs

R = 2048


def _segments(scene, seed):
    """Shadow origins on and around the scene (half of them on surfaces:
    the closest hits of random rays) and the scene's lights plus one more
    over the far corner."""
    _, jcs, pdata, _, pcs = shared_inputs(scene)
    jdata, _, _, cs = jax_accel(scene)
    o, d, act = scene_rays(cs, R, seed)
    hit = pct.cluster_closest_hit(pcs, torch.from_numpy(o), torch.from_numpy(d),
                                  1e-3, active=torch.from_numpy(act))
    surf = hit[0].numpy()
    org = np.where(surf[:, None], hit[5].numpy(), o + 0.5 * d).astype(np.float32)
    n_l = int(np.asarray(jdata.light_valid).sum())
    lights = np.asarray(jdata.light_pos, np.float32)[:n_l]
    cmax = np.nanmax(np.concatenate([cs.tri_cmax, cs.sph_cmax]), 0)
    lights = np.concatenate([lights, (cmax + [5.0, 20.0, 5.0])[None]]
                            ).astype(np.float32)
    return jcs, pcs, org, act, lights


@pytest.mark.parametrize("scene", ["terrain16", "spheres600", "spheres1200",
                                   "entry"])
@pytest.mark.parametrize("relaxed", [False, True])
def test_shadow_single_light_matches_jax(scene, relaxed):
    jcs, pcs, org, act, lights = _segments(scene, seed=21)
    lp = lights[0]
    seg = (lp[None] - org).astype(np.float32)
    planes = jct.build_shadow_planes(jcs, jnp.asarray(lp))
    f = jax.jit(lambda o, s, a: jct.cluster_shadow(
        jcs, planes, o, s, jnp.asarray(lp), active=a, relaxed=relaxed))
    jocc = np.asarray(f(*map(jnp.asarray, (org, seg, act))))
    pplanes = pct.build_shadow_planes(pcs, torch.from_numpy(lp))
    pocc = pct.cluster_shadow(pcs, pplanes, torch.from_numpy(org),
                              torch.from_numpy(seg), torch.from_numpy(lp),
                              active=torch.from_numpy(act), relaxed=relaxed).numpy()
    assert 0 < jocc[act].sum() < act.sum()
    diff = (jocc != pocc) & act
    assert diff.sum() == 0, f"{diff.sum()} occlusion bits differ"


@pytest.mark.parametrize("scene,bfc", [("terrain16", False), ("terrain16", True),
                                       ("spheres1200", False), ("spheres600", False)])
@pytest.mark.parametrize("relaxed", [False, True])
def test_shadow_multi_light_matches_jax(scene, bfc, relaxed):
    """All lights in one launch (the port's shadow kernel, the JAX
    package's _shadow_kernel_ml): per-light masks differ."""
    jcs, pcs, org, act, lights = _segments(scene, seed=22)
    if len(lights) < 2:
        lights = np.concatenate([lights, lights + 3.0])
    nl = len(lights)
    acts = np.stack([act & (np.arange(R) % (l + 2) != 0) for l in range(nl)], 1)
    jplanes = [jct.build_shadow_planes(jcs, jnp.asarray(lp), bfc=bfc) for lp in lights]
    f = jax.jit(lambda o, a: jct.cluster_shadow_multi(
        jcs, jplanes, o, jnp.asarray(lights), a, relaxed=relaxed))
    jocc = np.asarray(f(jnp.asarray(org), jnp.asarray(acts)))
    pplanes = [pct.build_shadow_planes(pcs, torch.from_numpy(lp), bfc=bfc)
               for lp in lights]
    pocc = pct.cluster_shadow_multi(pcs, pplanes, torch.from_numpy(org),
                                    torch.from_numpy(lights),
                                    torch.from_numpy(acts), relaxed=relaxed).numpy()
    assert pocc.shape == (R, nl)
    assert 0 < jocc[acts].sum() < acts.sum()
    diff = (jocc != pocc) & acts
    assert diff.sum() == 0, f"{diff.sum()} occlusion bits differ"


# ---------------------------------------------------------------------------
# NaN poison (tests/torch_poison_case.py): a lane >= 0 in one visit and NaN
# in another does not occlude
# ---------------------------------------------------------------------------

def _poison_lists(case):
    """The port's shortlists of the poison case, stacked on the light axis."""
    to_t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    shit = tuple(map(to_t, case["shit"]))
    per_light = [pct._lists(tuple(map(to_t, th)), shit) for th in case["thit"]]
    return [torch.stack(x) for x in zip(*per_light)], to_t


def _shadow_plain(case, lists, to_t):
    return K.shadow_plain(*lists, to_t(case["lps"]), to_t(case["origin"]),
                          to_t(case["planes"]), to_t(case["sph_dat"])).numpy()


@pytest.mark.parametrize("n_lights", [1, 2])
def test_shadow_nan_poison_matches_jax(n_lights):
    """shadow_plain against the JAX package's shadow call (interpret mode;
    _shadow_kernel for one light, _shadow_kernel_ml for two) and against
    the running-max rule in numpy: equal bits on every ray.  The case holds
    rays whose only >= 0 lane is NaN in another visit."""
    from torch_poison_case import poisoned_rays, poison_case

    case = poison_case(n_lights)
    assert poisoned_rays(case) >= 40
    lists, to_t = _poison_lists(case)
    got = _shadow_plain(case, lists, to_t)
    shit = tuple(map(jnp.asarray, case["shit"]))
    thits = [tuple(map(jnp.asarray, th)) for th in case["thit"]]
    org, sph = jnp.asarray(case["origin"]), jnp.asarray(case["sph_dat"])
    if n_lights == 1:
        want = np.asarray(jct._cluster_shadow_call(
            thits[0], shit, org, jnp.asarray(case["planes"][0]),
            jnp.asarray(case["lps"]), sph, 0)).astype(np.int32)
    else:
        want = np.asarray(jct._cluster_shadow_call_ml(
            tuple(thits), (shit,) * n_lights, org,
            [jnp.asarray(p) for p in case["planes"]], jnp.asarray(case["lps"]),
            sph, 0, n_lights))
    assert 100 < (want != 0).sum() < want.size - 100
    np.testing.assert_array_equal(want, case["truth"])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_lights", [1, 2])
def test_shadow_plain_visit_order_invariant(n_lights):
    """What a kernel that splits a tile's visits over warps relies on: the
    bits do not depend on the visit order.  Each listed tile's id list is
    permuted (the NaN-poisoned lanes included); the bitmask-scan tiles keep
    their ascending order."""
    from torch_poison_case import poison_case

    case = poison_case(n_lights, seed=1)
    lists, to_t = _poison_lists(case)
    want = _shadow_plain(case, lists, to_t)
    rng = np.random.default_rng(5)
    tl, tc = lists[1].clone(), lists[2]
    for l in range(n_lights):
        ids = tl[l].view(-1, K.MAX_TRI_LIST)
        for i, n in enumerate(tc[l].tolist()):
            if 1 < n <= K.MAX_TRI_LIST:
                ids[i, :n] = ids[i, torch.from_numpy(rng.permutation(n))]
    assert not torch.equal(tl, lists[1])
    got = _shadow_plain(case, [lists[0], tl, *lists[2:]], to_t)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# act: the rays whose bit is wanted; the result is act & occluded, and the
# tally counts the sphere walks' slots and live rays
# ---------------------------------------------------------------------------

def _act_inputs(path, n_lights, seed):
    """shadow_plain's inputs (lists, lps, origin, planes, sph_dat) on a
    sphere field with ``n_lights`` lights, one below the ground (every
    segment toward it crosses the ground's triangles) and the rest around
    the scene.  ``path``: "list" (spheres1200: 10 sphere clusters, its
    masks thinned so that most tiles' lists fit MAX_SPH_LIST), "bitmask"
    (its masks filled, so that most tiles walk the bitmask), "dense"
    (spheres600: 5 clusters, every one walked)."""
    scene = "spheres600" if path == "dense" else "spheres1200"
    _, pcs, org, act, lights = _segments(scene, seed)
    n = R if n_lights < 32 else R // 4          # 32 lights: 4 tiles
    org, act = org[:n], act[:n]
    rng = np.random.default_rng(seed)
    cmin = torch.cat([pcs.tri_cmin, pcs.sph_cmin]).numpy()
    cmax = torch.cat([pcs.tri_cmax, pcs.sph_cmax]).numpy()
    lo, hi = np.nanmin(cmin, 0), np.nanmax(cmax, 0)
    below = (0.5 * (lo + hi) - [0.0, hi[1] - lo[1] + 5.0, 0.0])[None]
    around = rng.uniform(lo - 0.5 * (hi - lo), hi + 0.5 * (hi - lo), (32, 3))
    lps = np.concatenate([below, lights, around]).astype(np.float32)[:n_lights]
    origin = torch.from_numpy(org)
    ones = torch.ones((n,))
    per_light = []
    for lp in lps:
        dirs = torch.from_numpy(lp)[None] - origin
        thit, (sh, se) = pct._cluster_masks(pcs, origin, dirs,
                                            torch.from_numpy(act), ones)
        if path == "list":
            sh = sh & torch.from_numpy(rng.random(sh.shape) < 0.4)
        elif path == "bitmask":
            fill = torch.from_numpy(rng.random(sh.shape) < 0.95)
            se = torch.where(sh, se, torch.from_numpy(
                rng.random(sh.shape).astype(np.float32)))
            sh = sh | fill
        per_light.append(pct._lists(thit, (sh, se)))
    lists = [torch.stack(x) for x in zip(*per_light)]
    planes = torch.stack([pct.build_shadow_planes(pcs, torch.from_numpy(lp))
                          for lp in lps])
    return lists, torch.from_numpy(lps.reshape(-1)), origin, planes, pcs.sph_dat


def _bits(act):
    """(R,) i32 bitfield of an (L, R) mask."""
    shift = torch.arange(act.shape[0], dtype=torch.int32)[:, None]
    return (act.to(torch.int32) << shift).sum(0, dtype=torch.int32)


@pytest.mark.parametrize("path", ["list", "bitmask", "dense"])
@pytest.mark.parametrize("relaxed", [False, True])
@pytest.mark.parametrize("n_lights", [1, 3, 32])
def test_shadow_plain_act_is_a_mask_of_the_bits(path, relaxed, n_lights):
    """shadow_plain(..., act=m) is shadow_plain(...) & m for random masks
    (bool and uint8), the all-false and the all-true one; its tally adds
    128 for each (tile, light) whose sphere walk runs (the light's sphere
    candidates, or with at most 8 sphere clusters any light's) and the
    rays of those walks that are active and not occluded by a triangle
    (the bits with every sphere's radius 0)."""
    lists, lps, origin, planes, sph = _act_inputs(path, n_lights, seed=31)
    r = origin.shape[0]
    sc, nt = lists[5], r // K.TILE
    cs = sph.shape[1] // K.CLUSTER
    assert (cs <= K.DENSE_SPH_ROWS) == (path == "dense")
    listed = int(((sc > 0) & (sc <= K.MAX_SPH_LIST)).sum())
    over = int((sc > K.MAX_SPH_LIST).sum())
    if path != "dense":
        assert (listed > over) == (path == "list") != (over > listed)
    full = K.shadow_plain(*lists, lps, origin, planes, sph, relaxed)
    flat = sph.clone()
    flat[3] = 0.0
    tri = K.shadow_plain(*lists, lps, origin, planes, flat, relaxed)
    assert bool((full != tri).any())
    rng = np.random.default_rng(n_lights)
    walks = (sc != 0 if cs > K.DENSE_SPH_ROWS
             else (sc != 0).any(0, keepdim=True).expand(n_lights, nt))
    tri_bits = torch.stack([(tri >> l) & 1 for l in range(n_lights)]) != 0
    for act in (torch.from_numpy(rng.random((n_lights, r)) < 0.6),
                torch.from_numpy((rng.random((n_lights, r)) < 0.3)
                                 .astype(np.uint8)),
                torch.zeros((n_lights, r), dtype=torch.bool),
                torch.ones((n_lights, r), dtype=torch.bool)):
        tally = torch.tensor([5, 7])
        got = K.shadow_plain(*lists, lps, origin, planes, sph, relaxed,
                             act=act, tally=tally)
        assert torch.equal(got, full & _bits(act != 0))
        live = ((act != 0) & ~tri_bits).view(n_lights, nt, K.TILE).sum(-1)
        assert tally.tolist() == [5 + K.TILE * int(walks.sum()),
                                  7 + int((live * walks).sum())]
    assert torch.equal(K.shadow_plain(*lists, lps, origin, planes, sph,
                                      relaxed, act=None), full)


@pytest.mark.parametrize("scene", ["terrain16", "spheres1200", "spheres600"])
def test_shadow_multi_bits_are_jax_bits_under_the_mask(scene):
    """cluster_shadow_multi's (R, L) bits on every lane are the JAX
    package's ANDed with the mask: unchanged where the mask is set, 0 where
    it is not (no scene here has the dense small-sphere test, which ORs
    bits of its own)."""
    jcs, pcs, org, act, lights = _segments(scene, seed=23)
    lights = np.concatenate([lights, lights + 3.0]).astype(np.float32)[:3]
    nl = len(lights)
    acts = np.stack([act & (np.arange(R) % (l + 2) != 0) for l in range(nl)], 1)
    jplanes = [jct.build_shadow_planes(jcs, jnp.asarray(lp)) for lp in lights]
    jocc = np.asarray(jax.jit(lambda o, a: jct.cluster_shadow_multi(
        jcs, jplanes, o, jnp.asarray(lights), a))(jnp.asarray(org),
                                                   jnp.asarray(acts)))
    pplanes = [pct.build_shadow_planes(pcs, torch.from_numpy(lp))
               for lp in lights]
    pocc = pct.cluster_shadow_multi(pcs, pplanes, torch.from_numpy(org),
                                    torch.from_numpy(lights),
                                    torch.from_numpy(acts)).numpy()
    assert 0 < (jocc & acts).sum() < (jocc & ~acts).sum() + acts.sum()
    np.testing.assert_array_equal(pocc, jocc & acts)
