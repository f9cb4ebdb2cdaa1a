"""Ray-triangle, ray-sphere and ray-AABB tests over broadcast batch dims
(port of ``raytracer_tpu/ops/intersect.py``).

The reference's acceptance rules:

- triangle: Cramer's rule with INCLUSIVE edges (alpha, beta, gamma >= 0),
  t >= 0 and no backface culling; a degenerate triangle gives det 0, so
  inf/NaN barycentrics, every comparison false: a miss.  ``bfc`` culls
  triangles whose normal points along the ray (``det_a < 0`` is kept).
- sphere: the quadratic's smaller root t1, reported EVEN WHEN NEGATIVE
  as long as not both roots are negative (origin inside the sphere).
- AABB: the slab test on a reciprocal direction; hit iff tmax >= max(0,
  tmin); returns tmin.  ``cpp_min``/``cpp_max`` are C++'s std::min/max,
  which return the FIRST argument when the comparison is false, so the
  0 * inf = NaN corner behaves as in the reference.

Every function rounds op by op in the JAX module's order (``_det3``'s
expansion included), so it equals eager ``jnp`` bit for bit.
"""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def normalize(v: torch.Tensor) -> torch.Tensor:
    """x / |x| with no epsilon, like the reference."""
    return v / torch.sqrt((v * v).sum(-1, keepdim=True))


def cpp_min(a, b):
    """std::min(a, b) == (b < a) ? b : a: ``a`` on a NaN comparison."""
    return torch.where(b < a, b, a)


def cpp_max(a, b):
    """std::max(a, b) == (a < b) ? b : a: ``a`` on a NaN comparison."""
    return torch.where(a < b, b, a)


def _det3(u, v, w):
    """Determinant of the 3x3 matrix with COLUMNS u, v, w, expanded in the
    reference's order."""
    return (
        u[..., 0] * (v[..., 1] * w[..., 2] - w[..., 1] * v[..., 2])
        - v[..., 0] * (u[..., 1] * w[..., 2] - w[..., 1] * u[..., 2])
        + w[..., 0] * (u[..., 1] * v[..., 2] - v[..., 1] * u[..., 2])
    )


def tri_intersect(origin, direction, a, b, c, bfc: bool = False):
    """(t, exists) of the rays against triangles (a, b, c); t is valid only
    where ``exists``."""
    ab = a - b
    ac = a - c
    ao = a - origin
    det_a = _det3(ab, ac, direction)
    beta = _det3(ao, ac, direction) / det_a
    gamma = _det3(ab, ao, direction) / det_a
    t = _det3(ab, ac, ao) / det_a
    alpha = 1.0 - beta - gamma
    exists = (alpha >= 0) & (beta >= 0) & (gamma >= 0) & (t >= 0)
    if bfc:
        exists = exists & (det_a < 0)
    return t, exists


def sphere_intersect(origin, direction, center, radius):
    """(t1, exists): the smaller root, negative when the origin is inside."""
    oc = origin - center
    b_coef = 2.0 * dot(direction, oc)
    a_coef = dot(direction, direction)
    c_coef = dot(oc, oc) - radius * radius
    disc = b_coef * b_coef - 4.0 * a_coef * c_coef
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t1 = (-b_coef - sq) / (2.0 * a_coef)
    t2 = (-b_coef + sq) / (2.0 * a_coef)
    exists = (disc >= 0) & ~((t1 < 0) & (t2 < 0))
    return t1, exists


def aabb_intersect(origin, inv_direction, box_min, box_max):
    """(tmin, exists) of the slab test; tmin < 0 when the origin is inside."""
    t1 = (box_min - origin) * inv_direction
    t2 = (box_max - origin) * inv_direction
    tmin = cpp_min(t1[..., 0], t2[..., 0])
    tmax = cpp_max(t1[..., 0], t2[..., 0])
    tmin = cpp_max(tmin, cpp_min(t1[..., 1], t2[..., 1]))
    tmax = cpp_min(tmax, cpp_max(t1[..., 1], t2[..., 1]))
    tmin = cpp_max(tmin, cpp_min(t1[..., 2], t2[..., 2]))
    tmax = cpp_min(tmax, cpp_max(t1[..., 2], t2[..., 2]))
    exists = tmax >= cpp_max(torch.zeros_like(tmin), tmin)
    return tmin, exists
