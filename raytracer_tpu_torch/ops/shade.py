"""Differentiable hit refinement, Blinn-Phong shading and mirror bounces
over the wavefront (port of ``raytracer_tpu/ops/shade.py``).

The visibility engines return primitive ids; ``refine_hit`` re-derives
t, the normal and the material from them differentiably, so gradients
flow into vertices, sphere radii, materials and lights while the hit
topology stays fixed (the ids carry no gradient).

The reference's semantics: ambient at every bounce; shadow and
illumination from the point offset along the unflipped geometric normal
by shadow_ray_epsilon; irradiance over the distance from the OFFSET
point; cosTheta from the UNOFFSET point; diffuse with clamp(cosTheta, 0,
1); Blinn-Phong specular gated by acos(cosTheta)*180/3.1415 <= 90.01 (the
reference's literal constants); mirror direction d + n*2(-d.n) from the
offset point, tinted by mat.mirror.

``bounce`` is the rest of a bounce from its hits: the brute and BVH
engines' and the differentiable path's, and the plain version of the
cluster engine's forward epilogue kernels (``cluster_trace.hit_record``
and ``shade_bounce``, ``csrc/shade.cu``), which compute the same per ray.

Material rows (and refine_hit's vertices and radii) are gathered with
``torch.index_select``: the same values as the JAX package's select chain
(``_mat_lookup``, which exists for XLA's fusion) bit for bit, and a
backward that adds into the table (``index_add_``).  Plain indexing's
backward sorts the indices and walks each one's duplicates serially on
the card: a million rays on two materials took 217 ms a gather in a
training step (H100).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from raytracer_tpu_torch.models.scene import SceneData, SceneMeta
from raytracer_tpu_torch.ops.intersect import _det3, dot, normalize

SPEC_GATE_DEG = 90.01
RAD_TO_DEG = 180.0 / 3.1415  # the reference's literal pi

# a light strictly behind the surface contributes nothing once cos_theta <
# cos(SPEC_GATE_DEG / RAD_TO_DEG) ~ -1.282e-4; minus a safety epsilon so
# float noise in cos_theta never skips a ray the gate would accept
RELEVANT_COS = float(math.cos(SPEC_GATE_DEG / RAD_TO_DEG)) - 5e-5


class Hit(NamedTuple):
    hit: torch.Tensor      # (R,)  bool
    t: torch.Tensor        # (R,)  f32, 1.0 on miss lanes
    normal: torch.Tensor   # (R,3) f32, unit, geometric, unflipped
    mat: torch.Tensor      # (R,)  i64, 0 on miss lanes
    point: torch.Tensor    # (R,3) f32, origin + t*dir
    offset: torch.Tensor   # (R,3) f32, point + normal*eps


def norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(-1))


def cross(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u x v over the LEADING axis of size 3 ((3,) vectors or (3, N) rows)."""
    return torch.stack([
        u[1] * v[2] - u[2] * v[1],
        u[2] * v[0] - u[0] * v[2],
        u[0] * v[1] - u[1] * v[0],
    ])


def refine_hit(data: SceneData, meta: SceneMeta, origin, dirs, prim) -> Hit:
    """The hit of each ray on its primitive ``prim`` (R,) (MISS: no hit),
    recomputed differentiably from the scene tensors.  Every division,
    square root and normalization is guarded on the lanes it does not
    serve, so no 0 * inf reaches a gradient (the where-grad trap)."""
    prim = prim.detach()
    t_pad = data.tri_v.shape[0]
    s_pad = data.sphere_cvid.shape[0]
    hit = prim >= 0
    p = torch.where(hit, prim, 0)
    is_tri = p < t_pad
    tri_lane = hit & is_tri
    sph_lane = hit & ~is_tri
    origin = origin.expand(dirs.shape)
    up = torch.zeros((3,), device=dirs.device)   # (0, 0, 1), no host copy
    up[2:].fill_(1.0)

    # triangle branch
    ti = torch.clamp(p, 0, t_pad - 1)
    v = data.tri_v[ti].long()
    a = torch.index_select(data.vertices, 0, v[:, 0])
    b = torch.index_select(data.vertices, 0, v[:, 1])
    c = torch.index_select(data.vertices, 0, v[:, 2])
    ab, ac, ao = a - b, a - c, a - origin
    det_a = _det3(ab, ac, dirs)
    safe_det = torch.where(tri_lane, det_a, 1.0)
    t_tri = _det3(ab, ac, ao) / safe_det
    cr = torch.linalg.cross(b - a, c - a)
    cr = torch.where(tri_lane[:, None], cr, up)
    n_tri = normalize(cr)

    # sphere branch
    si = torch.clamp(p - t_pad, 0, s_pad - 1)
    center = torch.index_select(data.vertices, 0,
                                data.sphere_cvid[si].long())
    rad = torch.index_select(data.sphere_rad, 0, si)
    oc = origin - center
    a_q = dot(dirs, dirs)
    b_q = 2.0 * dot(dirs, oc)
    c_q = dot(oc, oc) - rad * rad
    disc = b_q * b_q - 4.0 * a_q * c_q
    disc = torch.where(sph_lane, disc, 1.0)
    t_sph = (-b_q - torch.sqrt(torch.maximum(disc, torch.zeros_like(disc)))
             ) / (2.0 * a_q)
    safe_rad = torch.where(sph_lane, rad, 1.0)
    p_sph = origin + t_sph[:, None] * dirs
    n_sph_raw = (p_sph - center) / safe_rad[:, None]
    n_sph_raw = torch.where(sph_lane[:, None], n_sph_raw, up)
    n_sph = normalize(n_sph_raw)

    t = torch.where(is_tri, t_tri, t_sph)
    t = torch.where(hit, t, 1.0)
    normal = torch.where(is_tri[:, None], n_tri, n_sph)
    mat = torch.where(is_tri, data.tri_mat[ti], data.sphere_mat[si]).long()
    mat = torch.where(hit, mat, 0)
    point = origin + t[:, None] * dirs
    offset = point + normal * meta.shadow_eps
    return Hit(hit=hit, t=t, normal=normal, mat=mat, point=point,
               offset=offset)


def light_terms(data: SceneData, meta: SceneMeta, h: Hit):
    """(to_off (R, L, 3), light_dist (R, L), cos_theta (R, L), relevant
    (R, L)) of each hit and light: the segment from the offset point to
    the light, its length, the cosine at the unoffset point, and whether
    the light can contribute at all."""
    lp = data.light_pos[:meta.n_lights]
    to_off = lp[None, :, :] - h.offset[:, None, :]          # (R, L, 3)
    light_dist = norm(to_off)                               # (R, L)
    sdir_real = normalize(lp[None, :, :] - h.point[:, None, :])
    cos_theta = dot(sdir_real, h.normal[:, None, :])        # (R, L)
    # a light strictly behind the surface contributes nothing: skip its
    # shadow test (see RELEVANT_COS)
    relevant = cos_theta >= RELEVANT_COS
    return to_off, light_dist, cos_theta, relevant


def segments(offset, to_off, mask):
    """The generic any-hit's query (org, seg, t_max, mask) of the L*R
    shadow segments from the offset points (R, 3) (``to_off`` (R, L, 3),
    ``mask`` (R, L): the hit and relevant pairs), light-major, so each
    light's segments keep the rays' tile order."""
    r, nl = mask.shape
    return (offset[None].expand(nl, r, 3).reshape(nl * r, 3),
            to_off.transpose(0, 1).reshape(nl * r, 3),
            torch.ones((nl * r,), dtype=torch.float32, device=to_off.device),
            mask.T.reshape(nl * r))


def shadow_query(data: SceneData, meta: SceneMeta, h: Hit):
    """The arguments ``shade_local`` passes its ``occluded_fn`` for the hits
    ``h`` (meta.n_lights > 0), so that a caller can trace the occlusion
    ahead of the shading (the BVH walk between program steps)."""
    to_off, _, _, relevant = light_terms(data, meta, h)
    return segments(h.offset, to_off, h.hit[:, None] & relevant)


def shade_local(
    data: SceneData,
    meta: SceneMeta,
    dirs: torch.Tensor,
    h: Hit,
    shadow_fn: Optional[Callable] = None,
    shadow_multi_fn: Optional[Callable] = None,
    occluded_fn: Optional[Callable] = None,
    occ: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Ambient + per-light diffuse/specular; (R, 3), zero on miss lanes.

    Occlusion, the first that is given: ``occ`` (R, L) bool, the bits
    themselves; shadow_multi_fn(org, masks (R, L))
    -> (R, L) bool tests every light in one kernel launch;
    shadow_fn(org, seg, mask, l) -> (R,) bool tests light l;
    occluded_fn(org, seg, t_max, mask) -> (N,) bool is the generic any-hit,
    run as one light-major wavefront of L*R segments with t_max 1.
    ``mask`` marks the lanes whose result is read.
    """
    nl = meta.n_lights
    amb = (torch.index_select(data.mat_ambient, 0, h.mat)
           * data.ambient_light[None, :])
    color = torch.where(h.hit[:, None], amb, 0.0)
    if nl == 0:
        return color
    diffuse = torch.index_select(data.mat_diffuse, 0, h.mat)
    specular = torch.index_select(data.mat_specular, 0, h.mat)
    phong = data.mat_phong[h.mat]

    d_unit = normalize(dirs)
    n_unit = normalize(h.normal)

    lint = data.light_int[:nl]
    to_off, light_dist, cos_theta, relevant = light_terms(data, meta, h)
    sdir = to_off / light_dist[..., None]

    # occlusion is tested on the UNNORMALIZED segment light - origin with
    # t < 1, the reference's t < dist test in other units
    if occ is None and shadow_multi_fn is not None:
        occ = shadow_multi_fn(h.offset, h.hit[:, None] & relevant)
    elif occ is None and shadow_fn is not None:
        occ = torch.stack([
            shadow_fn(h.offset, to_off[:, l], h.hit & relevant[:, l], l)
            for l in range(nl)
        ], dim=1)
    elif occ is None:
        occ = occluded_fn(*segments(h.offset, to_off,
                                    h.hit[:, None] & relevant)).reshape(
            nl, dirs.shape[0]).T
    lit = h.hit[:, None] & relevant & ~occ
    irr = lint[None] / (light_dist * light_dist)[..., None]  # (R, L, 3)

    theta_deg = torch.arccos(cos_theta) * RAD_TO_DEG
    gate = theta_deg <= SPEC_GATE_DEG  # NaN (cos > 1) -> False, like C acos
    cos_h = torch.clamp_min(
        dot(n_unit[:, None, :], normalize(sdir - d_unit[:, None, :])), 0.0)
    spec = specular[:, None] * torch.pow(cos_h, phong[:, None])[..., None] * irr
    diff = diffuse[:, None] * torch.clamp(cos_theta, 0.0, 1.0)[..., None] * irr
    contrib = diff + torch.where(gate[..., None], spec, 0.0)
    return color + torch.where(lit[..., None], contrib, 0.0).sum(dim=1)


def reflection_rays(data: SceneData, dirs: torch.Tensor, h: Hit):
    """Mirror bounce: (origin, dir, tint, is_mirror) for the wavefront."""
    d_unit = normalize(dirs)
    n_unit = normalize(h.normal)
    cos_r = -dot(d_unit, n_unit)
    refl_dir = d_unit + n_unit * (2.0 * cos_r)[:, None]
    tint = torch.index_select(data.mat_mirror, 0, h.mat)
    is_mirror = data.mat_is_mirror[h.mat] & h.hit
    return h.offset, refl_dir, tint, is_mirror


def bounce(data: SceneData, meta: SceneMeta, carry, h: Hit, first: bool,
           fns=(None, None, None), occ: Optional[torch.Tensor] = None):
    """The rest of a bounce from its hits ``h``: the background of a depth-0
    (``first``) miss, the local shading (occlusion from ``occ`` or through
    ``fns``, the (shadow_fn, shadow_multi_fn, occluded_fn) of
    ``shade_local``), the mirror reflection.  ``carry``: (color,
    throughput, active, cur_org, cur_dir); returns the next."""
    color, throughput, active, cur_org, cur_dir = carry
    if first:
        color = color + torch.where((~h.hit & active)[:, None],
                                    data.background[None, :], 0.0)
    shadow_fn, shadow_multi_fn, occluded_fn = fns
    local = shade_local(data, meta, cur_dir, h, shadow_fn=shadow_fn,
                        shadow_multi_fn=shadow_multi_fn,
                        occluded_fn=occluded_fn, occ=occ)
    color = color + throughput * torch.where(h.hit[:, None], local, 0.0)
    refl_org, refl_dir, tint, is_mirror = reflection_rays(data, cur_dir, h)
    active = active & is_mirror
    throughput = torch.where(active[:, None], throughput * tint, 0.0)
    cur_org = torch.where(active[:, None], refl_org, cur_org)
    cur_dir = torch.where(active[:, None], refl_dir, cur_dir)
    return color, throughput, active, cur_org, cur_dir
