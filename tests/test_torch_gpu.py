"""On a machine with a CUDA card: each kernel equals its plain version on
the card (run with ``python -m pytest tests/test_torch_gpu.py -m gpu``;
``chip_smoke.py`` does the same at full size).  Skips without a card."""

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


def _render_and_compare(cuda, scene, kw, names, **render_kw):
    """Render at 64x64 on the card, keeping the inputs of every call of the
    wrappers ``names``; then each call's kernel equals its plain version."""
    from raytracer_tpu_torch.models.bvh import build_bvh
    from raytracer_tpu_torch.models.clusters import build_clusters
    from raytracer_tpu_torch.models.whitted import render_camera
    from raytracer_tpu_torch.ops import kernels as K
    from raytracer_tpu_torch.utils import synth

    data, meta = getattr(synth, scene)(res=64, device=cuda, **kw)
    cset = build_clusters(data, meta, build_bvh(data, meta))
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
        render_camera(data, meta, dataclasses.replace(meta.cameras[0]), cset,
                      device=cuda, **render_kw)
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
