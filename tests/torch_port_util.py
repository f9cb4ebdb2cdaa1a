"""Shared inputs of the tests that hold raytracer_tpu_torch (the PyTorch
port, run on the CPU through its plain kernel versions) against
raytracer_tpu (the JAX reference, pinned to the CPU by conftest.py).

Data crosses between the packages as numpy arrays.  Both sides build
their scenes with their own code; the kernel and render tests hand the
JAX package's accelerator to the port (``convert``) so that both trace
the very same clusters.

A note on float equality: XLA's CPU compiler contracts a*b+c into one
FMA inside jitted code and inside the Pallas interpreter (slab-mask
entries and sphere hit t then differ from the same expressions rounded
op by op), while eager PyTorch and the port's CUDA kernels (-fmad=false)
round every operation.  Discrete
results (hit bits, slots, primitives, occlusion bits) must therefore be
equal; continuous ones are compared to tolerances stated per test, and
exactly where the JAX side can run op by op (eager jnp).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
from typing import NamedTuple

import numpy as np
import pytest
import torch

# the suite runs in several worker processes at once: PyTorch's default of
# one thread per core in each of them oversubscribes the CPU many times over
torch.set_num_threads(1)

ENTRY_XML = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                         "entry_scene.xml")

SYNTH = {
    "terrain16": ("terrain_scene", dict(cells=16, res=64, mirror_stripes=True)),
    "spheres600": ("sphere_field", dict(n_spheres=600, res=64)),
    "spheres1200": ("sphere_field", dict(n_spheres=1200, res=64)),
    # max depth 3 with mirrors: the activity compaction fires at 64x64
    "terrain16d3": ("terrain_scene", dict(cells=16, res=64, mirror_stripes=True,
                                          max_depth=3)),
    # 64 triangle clusters: random rays overflow the 48-entry lists
    "terrain64": ("terrain_scene", dict(cells=64, res=64, mirror_stripes=True)),
}
HOST_SCENES = ["entry", "terrain16", "spheres600", "spheres1200"]


# scenes of the forward bounce epilogue's tests (cluster_trace.hit_record,
# cluster_trace.shade_bounce), one a route of the occlusion pass: 2 small
# spheres and 2 lights (shadow_multi); the same with 7 lights, one below
# the terrain (shadow_multi; up to 6 lit on a lane, so the kernel's light
# accumulators 0 and 1 each add two lights); a field of mirror spheres at
# depth 4 (the compaction); one light (per light); no light; and (the
# tests patch SHADOW_PLANES_BYTES_MAX to 0) the any-hit route
EPILOGUE_SCENES = ["terrain2sph", "terrain7l", "mirror_field", "entry",
                   "nolight", "any"]


def _mat(ambient, diffuse, specular, mirror, phong):
    return {"is_mirror": max(mirror) > 0, "ambient": [ambient] * 3,
            "diffuse": diffuse, "specular": [specular] * 3,
            "mirror": mirror, "phong": phong}


def epilogue_scene(name, device="cpu"):
    """(data, meta) of ``EPILOGUE_SCENES``' ``name``, 64x64."""
    from raytracer_tpu_torch.models.scene import from_parsed, load_scene

    if name == "entry":
        return load_scene(ENTRY_XML, device=device)
    lights = [([0.0, 60.0, 0.0], [2.5e5, 2.5e5, 2.4e5]),
              ([50.0, 40.0, 50.0], [1.2e5, 1.1e5, 1.0e5])]
    if name == "terrain7l":
        lights += [([-45.0, 30.0, 20.0], [6.0e4, 7.0e4, 9.0e4]),
                   ([20.0, 8.0, -40.0], [3.0e4, 2.5e4, 2.0e4]),
                   ([-10.0, 15.0, 35.0], [4.0e4, 4.0e4, 3.5e4]),
                   ([30.0, 45.0, -15.0], [5.0e4, 6.0e4, 5.0e4]),
                   ([5.0, -30.0, 0.0], [9.0e4, 9.0e4, 9.0e4])]
    camera = {"position": [0.0, 35.0, 75.0], "gaze": [0.0, -0.45, -1.0],
              "up": [0.0, 1.0, 0.0], "near_plane": [-1.0, 1.0, -1.0, 1.0],
              "near_distance": 1.0, "width": 64, "height": 64,
              "image_name": f"{name}.ppm"}
    materials = [_mat(0.1, [0.7, 0.6, 0.5], 0.2, [0.0, 0.0, 0.0], 20.0),
                 _mat(0.05, [0.2, 0.2, 0.25], 0.3, [0.6, 0.6, 0.65], 60.0),
                 _mat(0.05, [0.3, 0.2, 0.2], 0.5, [0.8, 0.7, 0.7], 35.0)]
    rng = np.random.default_rng(5)
    if name == "mirror_field":
        ii, jj = np.divmod(np.arange(144), 12)
        centers = np.stack([(ii - 5.5) * 8.0 + rng.normal(0, 1, 144),
                            3.0 + 2.0 * rng.random(144),
                            (jj - 5.5) * 8.0 + rng.normal(0, 1, 144)], 1)
        spheres = [(2 + k % 2, k + 1, 2.5 + rng.random())
                   for k in range(144)]
        verts, meshes, depth = centers, [], 4
    else:
        cells, n = 16, 17
        xg, zg = np.meshgrid(np.linspace(-50, 50, n), np.linspace(-50, 50, n),
                             indexing="ij")
        y = 4.0 * np.sin(xg / 7.0) * np.cos(zg / 9.0) + rng.normal(0, 0.15,
                                                                   xg.shape)
        grid = np.stack([xg, y, zg], -1).reshape(-1, 3)
        a = (np.arange(cells)[:, None] * n + np.arange(cells)[None, :]).ravel() + 1
        faces = np.concatenate([np.stack([a, a + 1, a + n], 1),
                                np.stack([a + 1, a + n + 1, a + n], 1)])
        stripe = (faces[:, 0] - 1) // n % 5 == 0
        meshes = [(2, [tuple(f) for f in faces[stripe]]),
                  (1, [tuple(f) for f in faces[~stripe]])]
        verts = np.concatenate([grid, [[-12.0, 12.0, 5.0], [10.0, 10.0, -4.0]]])
        spheres = [(1, n * n + 1, 8.0), (3, n * n + 2, 7.0)]
        depth = 2
    parsed = {"background": [20, 30, 60], "shadow_eps": 1e-3,
              "max_depth": depth, "cameras": [camera],
              "ambient_light": [40.0, 40.0, 40.0],
              "point_lights": [] if name == "nolight" else lights,
              "materials": materials, "vertices": verts.ravel().tolist(),
              "meshes": meshes, "triangles": [], "spheres": spheres}
    return from_parsed(parsed, device)


def _cloned(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        return type(x)(*map(_cloned, x)) if hasattr(x, "_fields") else \
            tuple(map(_cloned, x))
    return x


class EpilogueCall(NamedTuple):
    name: str        # hit_record or shade_bounce
    args: tuple      # the positional arguments, tensors cloned at the call
    inplace: bool    # shade_bounce writing the carry's own buffers

    def again(self):
        """The arguments cloned once more (a call may write into them)."""
        return _cloned(self.args)


@contextlib.contextmanager
def epilogue_calls():
    """Keeps every call of ``cluster_trace.hit_record`` and
    ``cluster_trace.shade_bounce`` inside the block as an ``EpilogueCall``
    (the frame must run eagerly: a replayed graph calls neither)."""
    from raytracer_tpu_torch.ops import cluster_trace as ctr

    calls = []
    wrapped = {n: getattr(ctr, n) for n in ("hit_record", "shade_bounce")}

    def spy(name):
        def f(*a, out=None, **kw):
            inplace = out is not None and all(
                o.data_ptr() == c.data_ptr() for o, c in zip(out, a[3]))
            calls.append(EpilogueCall(name, _cloned(a), inplace))
            return wrapped[name](*a, out=out, **kw) if out is not None \
                else wrapped[name](*a, **kw)
        return f

    for n in wrapped:
        setattr(ctr, n, spy(n))
    try:
        yield calls
    finally:
        for n, f in wrapped.items():
            setattr(ctr, n, f)


def jax_scene(name):
    if name == "entry":
        from raytracer_tpu.models.scene import load_scene

        return load_scene(ENTRY_XML)
    from raytracer_tpu.utils import synth

    fn, kw = SYNTH[name]
    return getattr(synth, fn)(**kw)


def port_scene(name):
    if name == "entry":
        from raytracer_tpu_torch.models.scene import load_scene

        return load_scene(ENTRY_XML, device="cpu")
    from raytracer_tpu_torch.utils import synth

    fn, kw = SYNTH[name]
    return getattr(synth, fn)(device="cpu", **kw)


def numpy_fields(obj) -> dict:
    """Dataclass fields as numpy arrays (ints stay ints)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None or isinstance(v, int):
            out[f.name] = v
        elif hasattr(v, "numpy") and not isinstance(v, np.ndarray):
            out[f.name] = v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)
        else:
            out[f.name] = np.asarray(v)
    return out


def port_meta(meta):
    """The JAX package's SceneMeta as the port's."""
    from raytracer_tpu_torch.models.scene import Camera, SceneMeta

    d = dataclasses.asdict(meta)
    d["cameras"] = tuple(Camera(**c) for c in d["cameras"])
    return SceneMeta(**d)


@functools.lru_cache(maxsize=None)
def jax_accel(name):
    """(data, meta, bvh, cset) built by the JAX package (numpy arrays)."""
    from raytracer_tpu.models.bvh import build_bvh
    from raytracer_tpu.models.clusters import build_clusters

    data, meta = jax_scene(name)
    bvh = build_bvh(data, meta)
    return data, meta, bvh, build_clusters(data, meta, bvh)


@functools.lru_cache(maxsize=None)
def shared_inputs(name):
    """(jax data, jax cset on device, port data, port meta, port cset):
    the JAX accelerator handed to the port."""
    import jax

    from raytracer_tpu_torch.convert import clusters_from_numpy, scene_from_numpy

    data, meta, _, cs = jax_accel(name)
    pdata = scene_from_numpy(numpy_fields(data), "cpu")
    pcs = clusters_from_numpy(numpy_fields(cs), "cpu")
    return (jax.device_put(data), jax.device_put(cs), pdata, port_meta(meta),
            pcs)


def assert_same(a, b, what: str) -> None:
    """Equal arrays (NaN equals NaN), shape and values."""
    a = np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, f"{what}: shape {a.shape} vs {b.shape}"
    if a.dtype.kind == "f":
        same = (a == b) | (np.isnan(a) & np.isnan(b))
    else:
        same = a == b
    assert same.all(), f"{what}: {int((~same).sum())} of {a.size} differ"


def scene_rays(cs, n: int, seed: int, eye=None):
    """(origin, dirs, active) f32/bool numpy: rays from random points
    around and above the scene's cluster boxes (or from ``eye``) toward
    random points inside them, so that most rays hit; 90% active."""
    cmin = np.concatenate([np.asarray(cs.tri_cmin), np.asarray(cs.sph_cmin)])
    cmax = np.concatenate([np.asarray(cs.tri_cmax), np.asarray(cs.sph_cmax)])
    lo, hi = np.nanmin(cmin, 0), np.nanmax(cmax, 0)
    ext = hi - lo
    rng = np.random.default_rng(seed)
    target = rng.uniform(lo, hi, (n, 3))
    origin = rng.uniform(lo - 0.5 * ext, hi + 0.5 * ext, (n, 3))
    origin[:, 1] += 0.5 * ext[1] + 1.0
    if eye is not None:
        origin[:] = eye
    dirs = (target - origin).astype(np.float32)
    active = rng.random(n) < 0.9
    return origin.astype(np.float32), dirs, active


def _pair64(cs, origin, dirs, slot):
    """Float64 re-evaluation of each ray against the primitive in ``slot``
    (-1: none): (t, margin, is_sphere), where margin says how far the hit
    decision is from flipping, relative to its terms (triangles: the least
    barycentric; spheres: the discriminant over b^2); NaN for slot -1."""
    tri = np.asarray(cs.tri_dat, np.float64)
    sph = np.asarray(cs.sph_dat, np.float64)
    pt = tri.shape[1]
    d = np.asarray(dirs, np.float64)
    o = np.broadcast_to(np.asarray(origin, np.float64), d.shape)
    t = np.full(len(d), np.nan)
    margin = np.full(len(d), np.nan)
    s = np.asarray(slot)
    it = np.nonzero((s >= 0) & (s < pt))[0]
    if it.size:
        r = tri[:, s[it]]
        nd = (d[it] * r[0:3].T).sum(1)
        tt = (r[9] - (o[it] * r[0:3].T).sum(1)) / nd
        p = o[it] + tt[:, None] * d[it]
        beta = (p * r[3:6].T).sum(1) - r[10]
        gamma = (p * r[6:9].T).sum(1) - r[11]
        t[it] = tt
        margin[it] = np.minimum(np.minimum(beta, gamma), 1 - beta - gamma)
    isp = np.nonzero(s >= pt)[0]
    if isp.size:
        r = sph[:, s[isp] - pt]
        oc = o[isp] - r[0:3].T
        a = (d[isp] ** 2).sum(1)
        b = 2 * (d[isp] * oc).sum(1)
        c = (oc ** 2).sum(1) - r[3] ** 2
        disc = b * b - 4 * a * c
        t[isp] = (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a)
        margin[isp] = disc / (b * b)
    return t, margin, s >= pt


def float32_ambiguous(cs, origin, dirs, slot_a, slot_b, t_a, t_b,
                      rtol=1e-4, edge=1e-4, graze=1e-3):
    """Lanes where two float32 evaluations of the same closest-hit query
    may rightly disagree: a differing slot or a t outside ``rtol``, where
    one of the two primitives is hit on a triangle edge (least barycentric
    within ``edge``) or grazing a sphere (discriminant within ``graze`` of
    b^2), or the two hits tie (float64 t within 1e-6).  Returns the bool
    mask of those lanes."""
    shaky = np.zeros(len(np.asarray(dirs)), bool)
    ts = []
    for slot in (slot_a, slot_b):
        t, m, sph = _pair64(cs, origin, dirs, slot)
        ts.append(t)
        shaky |= np.abs(np.nan_to_num(m, nan=1.0)) < np.where(sph, graze, edge)
    tie = np.isclose(ts[0], ts[1], rtol=1e-6, atol=0)
    differ = (np.asarray(slot_a) != np.asarray(slot_b)) | ~np.isclose(
        t_a, t_b, rtol=rtol, atol=0)
    return differ & (shaky | tie)


def prim_slots(cs, prim):
    """Kernel slot of each global primitive id (-1 stays -1).  The valid
    triangle slots are those with vertices (a treelet layout leaves
    padded gaps among them)."""
    tri_slot, sph_slot = np.asarray(cs.tri_slot), np.asarray(cs.sph_slot)
    pt = tri_slot.shape[0]
    inv = np.full(max(int(tri_slot.max()), int(sph_slot.max())) + 2, -1)
    inv[sph_slot[:cs.n_sph]] = pt + np.arange(cs.n_sph)
    valid = np.nonzero((np.asarray(cs.tri_verts) != 0).any(0))[0]
    inv[tri_slot[valid]] = valid
    prim = np.asarray(prim)
    return np.where(prim >= 0, inv[np.maximum(prim, 0)], -1)


def bad_pixels(a, b) -> int:
    """Pixels of two uint8 images whose channels differ by more than 1 LSB
    (the image bar: at most 4 on the test scenes)."""
    d = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int)).max(-1)
    return int((d > 1).sum())


def radiance_outside(a, b, rtol=1e-4, atol=1e-3) -> int:
    """Pixels of two radiance images outside rtol / atol (the radiance bar:
    at most 4 on the test scenes)."""
    close = np.isclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)
    return int((~close.all(-1)).sum())


def jax_band_jitter(seed: int):
    """The JAX package's jitter draws of a streamed frame, as the port's
    ``jitter(key, shape)``: band ``("band", row0)`` draws
    ``uniform(fold_in(PRNGKey(seed), row0), shape, -0.5, 0.5)``."""
    import jax
    import jax.numpy as jnp

    def draw(key, shape):
        stream, row0 = key
        assert stream == "band", key
        k = jax.random.fold_in(jax.random.PRNGKey(seed), row0)
        return np.asarray(jax.random.uniform(k, shape, jnp.float32,
                                             minval=-0.5, maxval=0.5))
    return draw


def jax_adaptive_jitter(seed: int):
    """The JAX package's adaptive-sampling draws as the port's ``jitter(key,
    shape)``: (kb, kr) = split(PRNGKey(seed)); the base wave draws from kb,
    round r from kr (r = 0) or fold_in(kr, r)."""
    import jax
    import jax.numpy as jnp

    kb, kr = jax.random.split(jax.random.PRNGKey(seed))

    def draw(key, shape):
        stream, i = key
        k = kb if stream == "base" else (kr if i == 0 else jax.random.fold_in(kr, i))
        return np.asarray(jax.random.uniform(k, shape, jnp.float32,
                                             minval=-0.5, maxval=0.5))
    return draw


# the depths at which pr9_render_rays took the compaction branch
pr9_compactions = []


def pr9_render_rays(data, meta, origin, dirs, accel, engine: str = "cluster",
                    differentiable: bool = False, bfc: bool = False,
                    relaxed: bool = False, compact_mode: str = "auto"):
    """PR 9's ``models.whitted.render_rays``, frozen: the bounce loop with
    its host reads (the compaction gate, the loop test, the un-compaction
    test) inside, the reference the restructured loop is held to."""
    from raytracer_tpu_torch.models.whitted import (
        _COMPACT_FROM, _COMPACT_MIN_DEPTH, _COMPACT_SCATTER, _debug,
    )
    from raytracer_tpu_torch.ops import cluster_trace as ctr
    from raytracer_tpu_torch.ops import traverse
    from raytracer_tpu_torch.ops.kernels import TILE
    from raytracer_tpu_torch.ops.shade import (
        Hit, refine_hit, reflection_rays, shade_local,
    )

    def _compact_carry(carry):
        depth, color, throughput, active, org, dirs, idx = carry
        pr9_compactions.append(depth)
        perm = torch.argsort((~active).to(torch.int32), stable=True)
        return (depth, color[perm], throughput[perm], active[perm], org[perm],
                dirs[perm], idx[perm])

    def _uncompact_color(color, idx):
        return color[torch.argsort(idx, stable=True)]

    if compact_mode not in ("auto", "deep"):
        raise ValueError(f"unknown compact_mode {compact_mode!r}")
    r = dirs.shape[0]
    fast_hits = engine == "cluster" and not differentiable
    nl = meta.n_lights
    shadow_fn = shadow_multi_fn = None

    def occluded_fn(org, seg, t_max, mask):
        return traverse.any_hit(data, org, seg, t_max, accel, engine,
                                active=mask, bfc=bfc, relaxed=relaxed)

    if engine == "cluster" and nl > 0:
        pt = accel.tri_verts.shape[1]
        if pt * 64 <= ctr.SHADOW_PLANES_BYTES_MAX:
            planes = [ctr.build_shadow_planes(accel, data.light_pos[l], bfc=bfc)
                      for l in range(nl)]

            def shadow_fn(org, sdir, mask, l):
                return ctr.cluster_shadow(accel, planes[l], org, sdir,
                                          data.light_pos[l], active=mask,
                                          relaxed=relaxed)

            # all lights in ONE kernel launch while every table fits together
            if nl >= 2 and nl * pt * 64 <= ctr.SHADOW_PLANES_BYTES_MAX:
                def shadow_multi_fn(org, masks):
                    return ctr.cluster_shadow_multi(
                        accel, planes, org, data.light_pos[:nl], masks,
                        relaxed=relaxed)

    compact = (fast_hits and (meta.max_depth >= _COMPACT_MIN_DEPTH
                              or compact_mode == "deep")
               and r % TILE == 0)

    def bounce(carry, shared_eye: bool = False):
        if compact and carry[0] >= _COMPACT_FROM:
            act = carry[3]
            act_f = act.to(torch.float32).mean()
            live_f = act.reshape(-1, TILE).any(1).to(torch.float32).mean()
            if bool(live_f - act_f > _COMPACT_SCATTER):
                carry = _compact_carry(carry)
        depth, color, throughput, active, cur_org, cur_dir, idx = carry
        if fast_hits:
            fhit, t, normal, mat, point, offset, _ = ctr.cluster_closest_hit(
                accel, origin if shared_eye else cur_org, cur_dir,
                meta.shadow_eps, active=active, bfc=bfc,
                shared_origin=shared_eye)
            h = Hit(hit=fhit & active, t=t, normal=normal, mat=mat,
                    point=point, offset=offset)
        else:
            prim = traverse.closest_hit(data, cur_org, cur_dir, accel, engine,
                                        active=active, bfc=bfc)
            prim = torch.where(active, prim, traverse.MISS)
            h = refine_hit(data, meta, cur_org, cur_dir, prim)
        if depth == 0:
            color = color + torch.where((~h.hit & active)[:, None],
                                        data.background[None, :], 0.0)
        local = shade_local(data, meta, cur_dir, h, shadow_fn=shadow_fn,
                            shadow_multi_fn=shadow_multi_fn,
                            occluded_fn=occluded_fn)
        color = color + throughput * torch.where(h.hit[:, None], local, 0.0)
        if _debug["nans"] and not bool(torch.isfinite(color).all()):
            raise FloatingPointError(
                f"radiance not finite after bounce {depth}")
        refl_org, refl_dir, tint, is_mirror = reflection_rays(data, cur_dir, h)
        active = active & is_mirror
        throughput = torch.where(active[:, None], throughput * tint, 0.0)
        cur_org = torch.where(active[:, None], refl_org, cur_org)
        cur_dir = torch.where(active[:, None], refl_dir, cur_dir)
        return depth + 1, color, throughput, active, cur_org, cur_dir, idx

    dev = dirs.device
    carry = (
        0,
        torch.zeros((r, 3), dtype=torch.float32, device=dev),
        torch.ones((r, 3), dtype=torch.float32, device=dev),
        torch.ones((r,), dtype=torch.bool, device=dev),
        origin.expand(r, 3),
        dirs,
        torch.arange(r, device=dev),
    )
    if differentiable:
        for _ in range(meta.max_depth + 1):
            carry = bounce(carry)
        return carry[1]
    if fast_hits and origin.dim() == 1:
        carry = bounce(carry, shared_eye=True)
    while carry[0] <= meta.max_depth and bool(carry[3].any()):
        carry = bounce(carry)
    color, idx = carry[1], carry[6]
    if compact and bool((idx != torch.arange(r, device=dev)).any()):
        color = _uncompact_color(color, idx)
    return color


class StubGraph:
    """Stands in for a CUDA graph on the CPU (``models.programs``): the
    capture keeps the body and runs nothing, as a capture does; each replay
    runs the body again on the static buffers it closed over, so a program
    whose inputs were not copied in, or whose steps read a temporary of an
    earlier run, gives a wrong frame here too."""

    def __init__(self, pool):
        self.body = None

    def capture(self, body):
        self.body = body

    def replay(self):
        self.body()


def use_stub_graphs(monkeypatch):
    """Programs on the CPU capture ``StubGraph``s (outside
    ``programs.eager()``); returns ``models.programs``."""
    from raytracer_tpu_torch.models import programs

    monkeypatch.setattr(programs, "graph_class", lambda device: (
        None if programs._eager[0] else StubGraph))
    return programs


@pytest.fixture
def stub_graphs(monkeypatch):
    """Renders and training steps on the CPU run as programs whose graphs
    are ``StubGraph``s (``use_stub_graphs``); no programs or replicas are
    kept before or after."""
    programs = use_stub_graphs(monkeypatch)
    programs.clear()
    yield programs
    programs.clear()


# The subset engines: the brute and BVH engines as they were when they
# traced the active lanes only (``torch.nonzero``, then a scatter of the
# results), frozen as the reference of the fixed-shape engines, with the
# iterations of every walk subset_closest_hit / subset_any_hit ran
subset_walk_iterations = []


def _subset_walk(data, bvh, origin, dirs, t_max, closest: bool,
               bfc: bool = False):
    """The subset engines' lockstep walk over the rays it is given, its
    loop test read on the host every _WALK_CHECK iterations."""
    from raytracer_tpu_torch.ops.intersect import aabb_intersect
    from raytracer_tpu_torch.ops.traverse import MISS, _WALK_CHECK, _prim_test

    dirs = dirs.detach()
    origin = origin.detach().expand(dirs.shape)
    dev = dirs.device
    r = dirs.shape[0]
    n = bvh.n_nodes
    n_total = bvh.blocks * n
    p_total = bvh.prim_idx.shape[0]
    inv_d = 1.0 / dirs
    if bvh.blocks == 8:
        octant = ((dirs < 0.0).long()
                  * torch.tensor([4, 2, 1], device=dev)).sum(-1)
        node = octant * n
    else:
        node = torch.zeros((r,), dtype=torch.int64, device=dev)
    end = node + n
    cursor = torch.zeros((r,), dtype=torch.int64, device=dev)
    remaining = torch.zeros((r,), dtype=torch.int64, device=dev)
    best_t = torch.full((r,), float("inf"), device=dev)
    best_p = torch.full((r,), MISS, dtype=torch.int64, device=dev)
    done = torch.zeros((r,), dtype=torch.bool, device=dev)
    it = 0
    while it % _WALK_CHECK or bool((~done & ((node < end)
                                             | (remaining > 0))).any()):
        it += 1
        in_leaf = (remaining > 0) & ~done
        p = bvh.prim_idx[torch.clamp(cursor, 0, p_total - 1)]
        t_p, ok_p = _prim_test(data, origin, dirs, p, bfc=bfc)
        if closest:
            upd = in_leaf & ok_p & (t_p < best_t)
            best_t = torch.where(upd, t_p, best_t)
            best_p = torch.where(upd, p, best_p)
        else:
            found = in_leaf & ok_p & (t_p < t_max)
            best_p = torch.where(found & (best_p == MISS), p, best_p)
            done = done | found
        cursor = torch.where(in_leaf, cursor + 1, cursor)
        remaining = torch.where(in_leaf, remaining - 1, remaining)
        at_node = ~in_leaf & (node < end) & ~done
        ni = torch.clamp(node, 0, n_total - 1)
        tmin, ok_box = aabb_intersect(origin, inv_d, bvh.box_min[ni],
                                      bvh.box_max[ni])
        visit = ok_box & (tmin <= best_t) if closest else ok_box
        count = bvh.leaf_count[ni]
        enter_leaf = at_node & visit & (count > 0)
        node = torch.where(at_node, torch.where(visit, node + 1,
                                                bvh.skip[ni]), node)
        remaining = torch.where(enter_leaf, count, remaining)
        cursor = torch.where(enter_leaf, bvh.leaf_start[ni], cursor)
    subset_walk_iterations.append(it)
    return best_p, done


def _subset_brute(data, origin, dirs, t_max, closest: bool, chunk: int = 512,
                bfc: bool = False):
    """The subset engines' ``brute_closest`` (closest) / ``brute_any``."""
    from raytracer_tpu_torch.ops.traverse import MISS, _prim_chunks, _ray_blocks

    dirs = dirs.detach()
    origin = origin.detach().expand(dirs.shape)
    r = dirs.shape[0]
    best_t = torch.full((r,), float("inf"), device=dirs.device)
    best_p = torch.full((r,), MISS, dtype=torch.int64, device=dirs.device)
    found = torch.zeros((r,), dtype=torch.bool, device=dirs.device)
    for test, ids in _prim_chunks(data, chunk):
        for a, e in _ray_blocks(r):
            t, ok = test(origin[a:e], dirs[a:e], bfc)
            if not closest:
                found[a:e] |= (ok & (t < t_max[a:e, None].detach())).any(1)
                continue
            t = torch.where(ok, t, float("inf"))
            tj, j = t.min(dim=1)
            upd = tj < best_t[a:e]
            best_t[a:e] = torch.where(upd, tj, best_t[a:e])
            best_p[a:e] = torch.where(upd, ids[j], best_p[a:e])
    return best_p if closest else found


def _subset_active_lanes(fn, active, fill, origin, dirs, *per_ray):
    """fn on the active lanes only, the fill on the others."""
    if active is None:
        return fn(origin, dirs, *per_ray)
    origin = origin.expand(dirs.shape)
    idx = torch.nonzero(active).squeeze(1)
    got = fn(origin[idx], dirs[idx], *(x[idx] for x in per_ray))
    out = torch.full(active.shape, fill, dtype=got.dtype, device=got.device)
    out[idx] = got
    return out


@torch.no_grad()
def subset_closest_hit(data, origin, dirs, accel, engine: str, active=None,
                     bfc: bool = False):
    """The subset engines' ``closest_hit`` on brute and bvh: the engine run
    on the ``active`` lanes only (``torch.nonzero``), MISS on the
    others."""
    from raytracer_tpu_torch.ops.traverse import MISS

    if engine == "bvh":
        fn = lambda o, d: _subset_walk(data, accel, o, d, None, True, bfc)[0]  # noqa: E731
    else:
        assert engine == "brute", engine
        fn = lambda o, d: _subset_brute(data, o, d, None, True, bfc=bfc)  # noqa: E731
    return _subset_active_lanes(fn, active, MISS, origin, dirs)


@torch.no_grad()
def subset_any_hit(data, origin, dirs, t_max, accel, engine: str, active=None,
                 bfc: bool = False, relaxed: bool = False):
    """The subset engines' ``any_hit`` on brute and bvh."""
    if engine == "bvh":
        fn = lambda o, d, t: _subset_walk(data, accel, o, d, t.detach(), False,  # noqa: E731
                                        bfc)[1]
    else:
        assert engine == "brute", engine
        fn = lambda o, d, t: _subset_brute(data, o, d, t, False, bfc=bfc)  # noqa: E731
    return _subset_active_lanes(fn, active, False, origin, dirs, t_max)


def subset_render_rays(data, meta, origin, dirs, accel, engine: str,
                     differentiable: bool = False):
    """``render_rays`` on brute and bvh as it was with the subset engines:
    the frozen loop ``pr9_render_rays`` (its brute/bvh path unchanged
    since) on them; one pass, its host reads inside."""
    from raytracer_tpu_torch.ops import traverse

    closest, any_ = traverse.closest_hit, traverse.any_hit
    traverse.closest_hit, traverse.any_hit = subset_closest_hit, subset_any_hit
    try:
        return pr9_render_rays(data, meta, origin, dirs, accel, engine=engine,
                               differentiable=differentiable)
    finally:
        traverse.closest_hit, traverse.any_hit = closest, any_
