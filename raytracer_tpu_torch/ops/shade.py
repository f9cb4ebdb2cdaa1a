"""Blinn-Phong shading and mirror bounces over the wavefront (port of the
forward path of ``raytracer_tpu/ops/shade.py``).

The reference's semantics: ambient at every bounce; shadow and
illumination from the point offset along the unflipped geometric normal
by shadow_ray_epsilon; irradiance over the distance from the OFFSET
point; cosTheta from the UNOFFSET point; diffuse with clamp(cosTheta, 0,
1); Blinn-Phong specular gated by acos(cosTheta)*180/3.1415 <= 90.01 (the
reference's literal constants); mirror direction d + n*2(-d.n) from the
offset point, tinted by mat.mirror.

Material columns are gathered by plain row indexing: the JAX package's
select chain (``_mat_lookup``) exists for XLA's fusion and returns the
same values bit for bit.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from raytracer_tpu_torch.models.scene import SceneData, SceneMeta

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


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(-1))


def cross(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u x v over the LEADING axis of size 3 ((3,) vectors or (3, N) rows)."""
    return torch.stack([
        u[1] * v[2] - u[2] * v[1],
        u[2] * v[0] - u[0] * v[2],
        u[0] * v[1] - u[1] * v[0],
    ])


def normalize(v: torch.Tensor) -> torch.Tensor:
    """x / |x| with no epsilon, like the reference."""
    return v / norm(v)[..., None]


def shade_local(
    data: SceneData,
    meta: SceneMeta,
    dirs: torch.Tensor,
    h: Hit,
    shadow_fn: Optional[Callable] = None,
    shadow_multi_fn: Optional[Callable] = None,
    occluded_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """Ambient + per-light diffuse/specular; (R, 3), zero on miss lanes.

    Occlusion, the first that is given: shadow_multi_fn(org, masks (R, L))
    -> (R, L) bool tests every light in one kernel launch;
    shadow_fn(org, seg, mask, l) -> (R,) bool tests light l;
    occluded_fn(org, seg, t_max, mask) -> (N,) bool is the generic any-hit,
    run as one light-major wavefront of L*R segments with t_max 1.
    ``mask`` marks the lanes whose result is read.
    """
    nl = meta.n_lights
    amb = data.mat_ambient[h.mat] * data.ambient_light[None, :]
    color = torch.where(h.hit[:, None], amb, 0.0)
    if nl == 0:
        return color
    diffuse = data.mat_diffuse[h.mat]
    specular = data.mat_specular[h.mat]
    phong = data.mat_phong[h.mat]

    d_unit = normalize(dirs)
    n_unit = normalize(h.normal)

    lp = data.light_pos[:nl]
    lint = data.light_int[:nl]
    to_off = lp[None, :, :] - h.offset[:, None, :]          # (R, L, 3)
    light_dist = norm(to_off)                               # (R, L)
    sdir = to_off / light_dist[..., None]
    sdir_real = normalize(lp[None, :, :] - h.point[:, None, :])
    cos_theta = dot(sdir_real, h.normal[:, None, :])        # (R, L)
    # a light strictly behind the surface contributes nothing: skip its
    # shadow test (see RELEVANT_COS)
    relevant = cos_theta >= RELEVANT_COS

    # occlusion is tested on the UNNORMALIZED segment light - origin with
    # t < 1, the reference's t < dist test in other units
    if shadow_multi_fn is not None:
        occ = shadow_multi_fn(h.offset, h.hit[:, None] & relevant)
    elif shadow_fn is not None:
        occ = torch.stack([
            shadow_fn(h.offset, to_off[:, l], h.hit & relevant[:, l], l)
            for l in range(nl)
        ], dim=1)
    else:
        # light-major, so each light's segments keep the rays' tile order
        r = dirs.shape[0]
        occ = occluded_fn(
            h.offset[None].expand(nl, r, 3).reshape(nl * r, 3),
            to_off.transpose(0, 1).reshape(nl * r, 3),
            torch.ones((nl * r,), dtype=torch.float32, device=dirs.device),
            (h.hit[:, None] & relevant).T.reshape(nl * r),
        ).reshape(nl, r).T
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
    tint = data.mat_mirror[h.mat]
    is_mirror = data.mat_is_mirror[h.mat] & h.hit
    return h.offset, refl_dir, tint, is_mirror
