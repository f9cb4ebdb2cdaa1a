"""The port's adaptive sampling (``ops/adaptive.py``) against the JAX
package's ``render_camera_adaptive`` on the same clusters and seed, with
nothing injected: the port draws the JAX package's samples (base wave and
every round).

Both sides score blocks by luma variance in float32, but XLA contracts
FMAs on the CPU, so two scores may differ in their last bits, and two
blocks whose scores lie that close may swap around the k-th place.  The
bar: wherever the JAX scores of the k-th and (k+1)-th blocks of a round
are more than ``RTOL`` apart (relative), both packages select the same
blocks, and every block's selected score equals the JAX block's at that
position within ``RTOL``.  The images are then held to the image bars (at
most 4 pixels > 1 LSB, at most 4 outside rtol 1e-4 / atol 1e-3) on the
blocks that both packages refined in the same rounds at the same
positions (all of them, when no round had a near tie)."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_port_util import (
    bad_pixels, jax_accel, radiance_outside, shared_inputs,
)

RTOL = 1e-3

CASES = [
    # scene, (width, height) or None, rounds, base_spp, extra_spp, refine_frac
    ("entry", None, 1, 4, 12, 0.125),
    ("entry", None, 3, 4, 12, 0.25),
    ("entry", (24, 20), 1, 2, 6, 0.125),
    ("entry", (24, 20), 3, 3, 7, 0.5),
    ("terrain16", None, 1, 4, 12, 0.125),
]


def _cams(scene, size):
    _, meta, _, _ = jax_accel(scene)
    jcam, pcam = meta.cameras[0], shared_inputs(scene)[3].cameras[0]
    if size is not None:
        jcam = dataclasses.replace(jcam, width=size[0], height=size[1])
        pcam = dataclasses.replace(pcam, width=size[0], height=size[1])
    return jcam, pcam


def _jax_round_scores(scene, cam, base_spp, per_round, k, seed):
    """The JAX scores each round selected on: ``_adaptive_jit`` returns the
    scores of its last round, so it runs once per prefix of the rounds."""
    import jax
    import jax.numpy as jnp

    from raytracer_tpu.ops.adaptive import _adaptive_jit, _tile_pixel_coords
    from raytracer_tpu.ops.camera import camera_vectors
    from raytracer_tpu.ops.tiling import divides

    jdata, jcs, _, _, _ = shared_inputs(scene)
    _, meta, _, _ = jax_accel(scene)
    rows, cols, inv, _ = _tile_pixel_coords(cam.height, cam.width, 8, 16)
    blocks = (8, 16) if divides(cam.height, cam.width, 8, 16) else None
    scores = []
    for r in range(1, len(per_round) + 1):
        _, score = _adaptive_jit(
            jdata, meta, jnp.asarray(camera_vectors(cam)), cam.height, cam.width,
            jnp.asarray(rows, jnp.float32), jnp.asarray(cols, jnp.float32),
            None if inv is None else jnp.asarray(inv), jax.random.PRNGKey(seed),
            jcs, "cluster", False, base_spp, tuple(per_round[:r]), k, 128, blocks,
            relaxed=False)
        scores.append(np.asarray(score))
    return scores


def _history(sels, nsel):
    """Per block, the (round, position) of every selection."""
    hist = [[] for _ in range(nsel)]
    for rnd, sel in enumerate(sels):
        for pos, b in enumerate(np.asarray(sel)):
            hist[b].append((rnd, pos))
    return hist


@pytest.mark.parametrize("scene,size,rounds,base_spp,extra_spp,frac", CASES)
def test_adaptive_matches_jax(scene, size, rounds, base_spp, extra_spp, frac,
                              monkeypatch):
    import jax

    from raytracer_tpu.ops.adaptive import render_camera_adaptive as jadaptive
    from raytracer_tpu_torch.ops import adaptive
    from raytracer_tpu_torch.ops.image import quantize

    seed = 11
    jdata, jcs, pdata, pmeta, pcs = shared_inputs(scene)
    _, meta, _, _ = jax_accel(scene)
    jcam, pcam = _cams(scene, size)
    kw = dict(base_spp=base_spp, extra_spp=extra_spp, refine_frac=frac,
              rounds=rounds, seed=seed)
    jimg, jstats = jadaptive(jdata, meta, jcam, bvh=jcs, engine="cluster", **kw)
    picked = []
    topk = adaptive.stable_topk
    monkeypatch.setattr(adaptive, "stable_topk",
                        lambda s, k: picked.append(topk(s, k)) or picked[-1])
    pimg, pstats = adaptive.render_camera_adaptive(
        pdata, pmeta, pcam, pcs, device="cpu", **kw)
    assert pstats == jstats
    k, nsel = pstats["refined_blocks"], pstats["refine_units"]
    per_round = pstats["extra_spp_per_round"]
    assert len(picked) == len(per_round) == rounds

    jsel = []
    for rnd, score in enumerate(_jax_round_scores(scene, jcam, base_spp,
                                                  per_round, k, seed)):
        sel = np.asarray(jax.lax.top_k(score, k)[1])
        jsel.append(sel)
        s = np.sort(score)[::-1]
        if k < nsel and s[k - 1] - s[k] > RTOL * abs(s[k - 1]):
            assert set(picked[rnd].tolist()) == set(sel.tolist()), f"round {rnd}"
        np.testing.assert_allclose(score[picked[rnd].numpy()], score[sel],
                                   rtol=RTOL, err_msg=f"round {rnd}")
    same = [a == b for a, b in zip(_history(picked, nsel), _history(jsel, nsel))]

    from raytracer_tpu_torch.ops.adaptive import _tile_pixel_coords

    rows, cols, _ = _tile_pixel_coords(pcam.height, pcam.width, 8, 16)
    keep = np.zeros((pcam.height, pcam.width), bool)
    for b in np.nonzero(same)[0]:
        keep[rows[b * 128:(b + 1) * 128], cols[b * 128:(b + 1) * 128]] = True
    assert keep.mean() > 0.7
    p, j = pimg.numpy(), np.array(jimg)
    assert p.shape == j.shape == (pcam.height, pcam.width, 3)
    assert np.isfinite(p).all()
    assert bad_pixels(quantize(pimg).numpy()[keep],
                      quantize(torch.from_numpy(j)).numpy()[keep]) <= 4
    assert radiance_outside(p[keep], j[keep]) <= 4


@pytest.mark.parametrize("size,rounds", [(None, 1), (None, 3), ((24, 20), 1)])
def test_adaptive_deterministic_and_seeded(size, rounds):
    """The port's own draws: one seed, one image; another seed, another."""
    from raytracer_tpu_torch.ops.adaptive import render_camera_adaptive

    _, _, pdata, pmeta, pcs = shared_inputs("entry")
    _, cam = _cams("entry", size)
    kw = dict(base_spp=3, extra_spp=6, refine_frac=0.25, rounds=rounds,
              device="cpu")
    a, sa = render_camera_adaptive(pdata, pmeta, cam, pcs, seed=3, **kw)
    b, sb = render_camera_adaptive(pdata, pmeta, cam, pcs, seed=3, **kw)
    c, _ = render_camera_adaptive(pdata, pmeta, cam, pcs, seed=4, **kw)
    assert torch.equal(a, b) and sa == sb
    assert not torch.equal(a, c)


def test_only_selected_blocks_refined(monkeypatch):
    """Refinement only adds samples to the selected blocks: every other
    block equals the base-only render bit for bit, and every selected
    block with variance changes."""
    from raytracer_tpu_torch.ops import adaptive
    from raytracer_tpu_torch.ops.tiling import to_blocks

    _, _, pdata, pmeta, pcs = shared_inputs("entry")
    cam = pmeta.cameras[0]
    base, _ = adaptive.render_camera_adaptive(pdata, pmeta, cam, pcs,
                                              extra_spp=0, device="cpu")
    picked = []
    topk = adaptive.stable_topk
    monkeypatch.setattr(adaptive, "stable_topk",
                        lambda s, k: picked.append((s, topk(s, k))) or picked[-1][1])
    ref, stats = adaptive.render_camera_adaptive(pdata, pmeta, cam, pcs,
                                                 device="cpu")
    changed = to_blocks((base != ref).any(-1).reshape(-1, 1), cam.height,
                        cam.width, 8, 16).reshape(stats["blocks"], 128).any(1)
    score, sel = picked[0]
    assert not changed[[b for b in range(stats["blocks"]) if b not in sel]].any()
    assert bool(changed[sel[score[sel] > 0]].all())
    assert stats["refined_blocks"] == 4 and stats["mean_spp"] == 5.5


def test_stable_topk_tie_order():
    """Equal scores come out in ascending index order, as jax.lax.top_k
    gives them."""
    import jax
    import jax.numpy as jnp

    from raytracer_tpu_torch.ops.adaptive import stable_topk

    rng = np.random.default_rng(0)
    score = rng.integers(0, 4, 257).astype(np.float32)
    score[::7] = 0.5
    for k in (1, 5, 64, 257):
        got = stable_topk(torch.from_numpy(score), k).numpy()
        want = np.asarray(jax.lax.top_k(jnp.asarray(score), k)[1])
        np.testing.assert_array_equal(got, want)


def test_adaptive_argument_checks():
    from raytracer_tpu_torch.ops.adaptive import render_camera_adaptive

    _, _, pdata, pmeta, pcs = shared_inputs("entry")
    cam = pmeta.cameras[0]
    for kw, match in ((dict(base_spp=1), "base_spp"), (dict(rounds=0), "rounds"),
                      (dict(extra_spp=2, rounds=3), "exceeds")):
        with pytest.raises(ValueError, match=match):
            render_camera_adaptive(pdata, pmeta, cam, pcs, device="cpu", **kw)
