"""The cluster engine's forward bounce epilogue on the CPU: the entry
points ``cluster_trace.hit_record`` and ``cluster_trace.shade_bounce``
send CPU tensors to their plain versions and count no launch, in every
occlusion route; the
occlusion routes keep their small-sphere test at the keyword's default,
so the differentiable path is the one it was (held against the frozen
loop ``pr9_render_rays``).  The kernels themselves are held to the plain
versions on the card (``tests/test_torch_gpu.py``)."""

from __future__ import annotations

import pytest
import torch

from torch_port_util import (
    EPILOGUE_SCENES, epilogue_calls, epilogue_scene, pr9_render_rays,
)


def _scene(name, monkeypatch):
    from raytracer_tpu_torch.models.bvh import build_bvh
    from raytracer_tpu_torch.models.clusters import build_clusters
    from raytracer_tpu_torch.ops import cluster_trace

    if name == "any":
        monkeypatch.setattr(cluster_trace, "SHADOW_PLANES_BYTES_MAX", 0)
    data, meta = epilogue_scene(name)
    return data, meta, build_clusters(data, meta, build_bvh(data, meta))


def _eye(meta):
    from raytracer_tpu_torch.models import whitted
    from raytracer_tpu_torch.ops.camera import camera_vectors, eye_rays_from

    cam = meta.cameras[0]
    origin, dirs = eye_rays_from(torch.from_numpy(camera_vectors(cam)),
                                 cam.width, cam.height)
    blocks, perm, _ = whitted._tile_order(cam.height, cam.width, "cpu")
    return origin, whitted.apply_tile_order(dirs, cam.height, cam.width,
                                            blocks, perm).contiguous()


def _flat(out):
    return [x for o in out for x in (o if isinstance(o, tuple) else (o,))]


@pytest.mark.parametrize("scene", EPILOGUE_SCENES)
def test_epilogue_wrappers_take_the_plain_versions_on_cpu(scene,
                                                          monkeypatch):
    from raytracer_tpu_torch.models import whitted
    from raytracer_tpu_torch.ops import cluster_trace as ctr
    from raytracer_tpu_torch.ops import kernels as K

    data, meta, cset = _scene(scene, monkeypatch)
    origin, dirs = _eye(meta)
    bounces = []
    bounce = whitted._fused_bounce
    monkeypatch.setattr(whitted, "_fused_bounce",
                        lambda *a, **kw: bounces.append(a[5][0])
                        or bounce(*a, **kw))
    before = dict(K.launches)
    with epilogue_calls() as calls:
        whitted.render_rays(data, meta, origin, dirs, cset)
    assert K.launches == before
    assert [c.name for c in calls] == ["hit_record", "shade_bounce"] * len(
        bounces)
    assert len(bounces) >= 2
    for call in calls:
        wrapper = getattr(ctr, call.name)
        plain = getattr(ctr, call.name + "_plain")
        got, want = _flat(wrapper(*call.again())), _flat(plain(*call.again()))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert (a is b is None) or torch.equal(a, b), call.name


def _routes(data, meta, cset, offset, mask, relaxed, **kw):
    """Each occlusion route's (R, L) bits for the shadow segments."""
    from raytracer_tpu_torch.ops import cluster_trace as ctr
    from raytracer_tpu_torch.ops import shade

    nl = meta.n_lights
    planes = [ctr.build_shadow_planes(cset, data.light_pos[l])
              for l in range(nl)]
    multi = ctr.cluster_shadow_multi(cset, planes, offset, data.light_pos[:nl],
                                     mask, relaxed=relaxed, **kw)
    per_light = torch.stack([
        ctr.cluster_shadow(cset, planes[l], offset, data.light_pos[l] - offset,
                           data.light_pos[l], active=mask[:, l],
                           relaxed=relaxed, **kw) for l in range(nl)], 1)
    to_off = data.light_pos[:nl][None] - offset[:, None]
    org, seg, t_max, act = shade.segments(offset, to_off, mask)
    any_ = ctr.cluster_any(cset, org, seg, t_max, active=act, relaxed=relaxed,
                           **kw).reshape(nl, -1).T
    return {"multi": multi, "per_light": per_light, "any": any_}


@pytest.mark.parametrize("relaxed", [False, True])
@pytest.mark.parametrize("route", ["multi", "per_light", "any"])
def test_occlusion_routes_keep_the_small_sphere_test_by_default(route,
                                                                relaxed):
    """The keyword's default is the route as it was: its own bits ORed
    with the dense test of the scene's two spheres, which occlude some of
    the terrain's shadow segments."""
    from raytracer_tpu_torch.models.bvh import build_bvh
    from raytracer_tpu_torch.models.clusters import build_clusters
    from raytracer_tpu_torch.ops import cluster_trace as ctr

    data, meta = epilogue_scene("terrain2sph")
    cset = build_clusters(data, meta, build_bvh(data, meta))
    origin, dirs = _eye(meta)
    h, mask = ctr.hit_record(data, meta, cset, *ctr.cluster_closest_slots(
        cset, origin, dirs, shared_origin=True), origin, dirs,
        torch.ones(dirs.shape[0], dtype=torch.bool))
    default = _routes(data, meta, cset, h.offset, mask, relaxed)[route]
    on = _routes(data, meta, cset, h.offset, mask, relaxed,
                 small_spheres=True)[route]
    off = _routes(data, meta, cset, h.offset, mask, relaxed,
                  small_spheres=False)[route]
    dense = ctr._small_sphere_test_multi(
        cset, h.offset, data.light_pos[:meta.n_lights].reshape(-1), relaxed)
    assert torch.equal(default, on)
    assert torch.equal(default, off | dense)
    assert bool((default & ~off & mask).any())


@pytest.mark.parametrize("scene", ["terrain2sph", "entry"])
def test_differentiable_render_keeps_its_occlusion(scene, monkeypatch):
    """render_rays(differentiable=True) (the routes at their default,
    ``shade.shade_local``) equals the frozen loop ``pr9_render_rays`` bit
    for bit."""
    from raytracer_tpu_torch.models import whitted

    data, meta, cset = _scene(scene, monkeypatch)
    origin, dirs = _eye(meta)
    got = whitted.render_rays(data, meta, origin, dirs, cset,
                              differentiable=True)
    want = pr9_render_rays(data, meta, origin, dirs, cset,
                           differentiable=True)
    assert torch.equal(got, want)
