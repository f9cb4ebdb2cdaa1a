"""The port's copy of JAX's threefry key algebra (``ops/random.py``, the
plain version of ``csrc/threefry.cu``) against ``jax.random`` bit for bit,
the jitter and adaptive draws keyed as the JAX package keys them, and
renders under one seed with nothing injected against the JAX package's
(the image bars: at most 4 pixels > 1 LSB, fewer than 1%)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (
    bad_pixels, jax_accel, jax_adaptive_jitter, jax_band_jitter, shared_inputs,
)

SEEDS = [0, 1, 3, 7, 2**31 - 1, 2**31, 2**32 - 1]
ROWS = [0, 16, 48, 2032]
SHAPES = [(16, 24, 2), (48, 512, 2), (3, 4, 128, 2), (5, 7, 2)]


def _key(k):
    return tuple(int(x) for x in np.asarray(k))


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS + [-1, -5, 2**32 + 7, -(2**63)])
def test_prng_key_matches_jax(seed):
    from raytracer_tpu_torch.ops.random import prng_key

    assert prng_key(seed) == _key(jax.random.PRNGKey(seed)) == (0, seed % 2**32)


def test_prng_key_out_of_int64_raises_like_jax():
    from raytracer_tpu_torch.ops.random import prng_key

    for seed in (2**63, -(2**63) - 1):
        with pytest.raises(OverflowError):
            jax.random.PRNGKey(seed)
        with pytest.raises(OverflowError):
            prng_key(seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_and_split_match_jax(seed):
    """fold_in with every band row, split, and the adaptive rounds' keys
    (kr, then fold_in(kr, r)): equal words."""
    from raytracer_tpu_torch.ops.random import fold_in, prng_key, split

    k, jk = prng_key(seed), jax.random.PRNGKey(seed)
    for row0 in ROWS:
        assert fold_in(k, row0) == _key(jax.random.fold_in(jk, row0))
    kb, kr = split(k)
    jkb, jkr = jax.random.split(jk)
    assert (kb, kr) == (_key(jkb), _key(jkr))
    for r in (1, 2):
        assert fold_in(kr, r) == _key(jax.random.fold_in(jkr, r))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 3, 2**31, 2**32 - 1])
def test_uniform_matches_jax(seed, shape):
    """The plain uniform in [-0.5, 0.5) and in [0, 1): the same float bits."""
    from raytracer_tpu_torch.ops.random import fold_in, prng_key, uniform

    k = fold_in(prng_key(seed), 48)
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 48)
    got = uniform(k, shape, -0.5, 0.5, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    want = jax.random.uniform(jk, shape, jnp.float32, minval=-0.5, maxval=0.5)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    np.testing.assert_array_equal(
        _bits(uniform(k, shape, device="cpu").numpy()),
        _bits(jax.random.uniform(jk, shape, jnp.float32)))


@pytest.mark.parametrize("seed", SEEDS)
def test_draws_match_jax_keys(seed):
    """draw_jitter without injection gives the JAX package's arrays bit for
    bit: bands at every row (uniform(fold_in(PRNGKey(seed), row0))), the
    adaptive base wave (kb) and rounds 0-2 (kr, fold_in(kr, r))."""
    from raytracer_tpu_torch.ops.camera import draw_jitter

    band, adaptive = jax_band_jitter(seed), jax_adaptive_jitter(seed)
    for key, shape, ref in ([(("band", r), (16, 24, 2), band) for r in ROWS]
                            + [(("base", 0), (3, 4, 128, 2), adaptive)]
                            + [(("round", r), (5, 7, 2), adaptive)
                               for r in range(3)]):
        got = draw_jitter(None, seed, key, shape, "cpu")
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref(key, shape)),
                                      err_msg=str(key))


@pytest.mark.parametrize("seed", [-1, 2**32 + 7])
def test_out_of_range_seeds_per_route(seed):
    """JAX's own behaviour on each route: the streamed route's
    ``jnp.uint32(seed)`` raises OverflowError (so does the port's band
    draw), the adaptive route's ``PRNGKey(seed)`` wraps mod 2**32 (so do
    the port's base and round keys)."""
    from raytracer_tpu.models.whitted import render_camera_streamed as jstreamed
    from raytracer_tpu_torch.models.whitted import render_camera_streamed
    from raytracer_tpu_torch.ops.camera import jitter_key
    from raytracer_tpu_torch.ops.random import fold_in

    jdata, jcs, pdata, pmeta, pcs = shared_inputs("entry")
    _, meta, _, _ = jax_accel("entry")
    with pytest.raises(OverflowError):
        jstreamed(jdata, meta, meta.cameras[0], bvh=jcs, engine="cluster",
                  ssaa=2, ssaa_mode="jitter", seed=seed)
    with pytest.raises(OverflowError, match="uint32"):
        render_camera_streamed(pdata, pmeta, pmeta.cameras[0], pcs, ssaa=2,
                               ssaa_mode="jitter", seed=seed, device="cpu")
    jkb, jkr = jax.random.split(jax.random.PRNGKey(seed))
    assert jitter_key(seed, ("base", 0)) == _key(jkb)
    assert jitter_key(seed, ("round", 0)) == _key(jkr)
    assert jitter_key(seed, ("round", 2)) == fold_in(_key(jkr), 2)
    assert jitter_key(seed, ("base", 0)) == jitter_key(seed % 2**32, ("base", 0))


def _cam(meta, scene):
    cam = meta.cameras[0]
    return cam if scene == "entry" else dataclasses.replace(cam, width=64, height=64)


@pytest.mark.parametrize("mode", ["jitter", "adaptive"])
@pytest.mark.parametrize("scene", ["entry", "terrain16"])
def test_seeded_render_matches_jax(scene, mode):
    """render_one_camera at --ssaa 2 under seed 3, nothing injected, on the
    entry scene and the 64x64 terrain: the JAX package's image at the image
    bars (and its adaptive stats)."""
    from raytracer_tpu.pipeline import render_one_camera as jrender
    from raytracer_tpu_torch.pipeline import render_one_camera

    jdata, jcs, pdata, pmeta, pcs = shared_inputs(scene)
    _, meta, _, _ = jax_accel(scene)
    kw = dict(ssaa=2, ssaa_mode=mode, seed=3)
    j, jstats = jrender(jdata, meta, _cam(meta, scene), jcs, engine="cluster", **kw)
    p, pstats = render_one_camera(pdata, pmeta, _cam(pmeta, scene), pcs,
                                  device="cpu", **kw)
    assert pstats == jstats
    n_bad = bad_pixels(p, np.asarray(j))
    assert p.shape == (64, 64, 3) and p.max() > 0
    assert n_bad <= 4 and n_bad < 0.01 * 64 * 64, n_bad


@pytest.mark.parametrize("scene", ["entry", "terrain16"])
def test_seeded_jitter_on_2_shards_matches_jax(scene):
    """Jitter on a 2-shard mesh (the CPU's logical shards against JAX's
    first 2 of its 8 CPU devices), seed 3, nothing injected: the JAX mesh
    image at the image bars."""
    from raytracer_tpu.parallel.mesh import make_mesh as jmake_mesh
    from raytracer_tpu.pipeline import render_one_camera as jrender
    from raytracer_tpu_torch.parallel.mesh import make_mesh
    from raytracer_tpu_torch.pipeline import render_one_camera

    jdata, jcs, pdata, pmeta, pcs = shared_inputs(scene)
    _, meta, _, _ = jax_accel(scene)
    kw = dict(ssaa=2, ssaa_mode="jitter", seed=3, chunk=64 * 2 * 16 + 5)
    j, _ = jrender(jdata, meta, _cam(meta, scene), jcs, engine="cluster",
                   mesh=jmake_mesh(n=2), **kw)
    p, _ = render_one_camera(pdata, pmeta, _cam(pmeta, scene), pcs, device="cpu",
                             mesh=make_mesh(devices=["cpu"] * 2), **kw)
    n_bad = bad_pixels(p, np.asarray(j))
    assert n_bad <= 4 and n_bad < 0.01 * 64 * 64, n_bad
