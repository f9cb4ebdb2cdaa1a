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
