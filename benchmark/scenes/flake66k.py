"""The SPD sphereflake (Haines' Standard Procedural Databases, ``balls.c``)
at its size factor: a root sphere carrying nine children of a third of
its radius, each tangent to it, each child carrying nine of its own, down
to the size factor's level (size factor 5: 66,430 spheres), on a square
ground polygon (two triangles), three point lights, one camera.

The nine children of a sphere lie along the directions of its frame
whose z axis runs from its parent to it (the root's: +z): six about its
equator at azimuths 15 + 60k degrees and three above it at an elevation
of atan(sqrt 2) and azimuths 45 + 120k degrees; a child's frame is the
parent's turned by the least rotation that takes +z onto the axis.  The
NFF view (from, at, up, angle) is written as CENG477's camera: the gaze
the unit vector from the eye to the look-at point, the up orthogonalized
to it, a near plane of +-tan(angle / 2) at distance 1.  The scene is
built z-up, as ``balls.c`` builds it, then turned to y-up by the
rotation (x, y, z) -> (x, z, -y).

``generate(seed, cfg)`` returns the parsed-scene dict that the XML writer
(``benchmark/sceneio.py``) and the plain reference take.  The geometry,
materials, lights and camera are the configuration's and do not depend
on the seed; the seed orders the spheres in the file (and so the input
order of the program's cluster build).  A sphere's level is its radius's:
``radius = root_radius / 3**level``.
"""

from __future__ import annotations

import numpy as np


def child_directions(cfg: dict) -> np.ndarray:
    """(9, 3) unit directions of a sphere's children in its own frame."""
    s = cfg["scene"]
    az = np.radians([15.0 + 60.0 * k for k in range(6)])
    top = np.radians([45.0 + 120.0 * k for k in range(3)])
    el = np.radians(s["top_elevation_deg"])
    ring = np.stack([np.cos(az), np.sin(az), np.zeros(6)], 1)
    cap = np.stack([np.cos(el) * np.cos(top), np.cos(el) * np.sin(top),
                    np.full(3, np.sin(el))], 1)
    return np.concatenate([ring, cap])


def _frames(axes: np.ndarray) -> np.ndarray:
    """(N, 3, 3) least rotations taking +z onto each unit axis (a half
    turn about x for -z)."""
    x, y, c = axes[:, 0], axes[:, 1], axes[:, 2]
    k = np.zeros((len(axes), 3, 3))
    k[:, 0, 2], k[:, 1, 2] = x, y
    k[:, 2, 0], k[:, 2, 1] = -x, -y
    flip = c < -1.0 + 1e-12
    scale = np.where(flip, 0.0, 1.0 / np.where(flip, 1.0, 1.0 + c))
    rot = np.eye(3)[None] + k + (k @ k) * scale[:, None, None]
    rot[flip] = np.diag([1.0, -1.0, -1.0])
    return rot


def flake(cfg: dict):
    """(centres (N, 3), radii (N,), levels (N,)) of the sphereflake, z-up,
    level by level (the root first)."""
    s = cfg["scene"]
    dirs = child_directions(cfg)
    ratio = s["child_radius_ratio"]
    centres = [np.zeros((1, 3))]
    radii = [np.full(1, s["root_radius"])]
    axes = np.array([[0.0, 0.0, 1.0]])
    for _ in range(s["size_factor"]):
        c, r = centres[-1], radii[-1]
        d = np.einsum("nij,kj->nki", _frames(axes), dirs).reshape(-1, 3)
        parent_r = np.repeat(r, len(dirs))
        centres.append(np.repeat(c, len(dirs), 0)
                       + d * (parent_r * (1.0 + ratio))[:, None])
        radii.append(parent_r * ratio)
        axes = d
    levels = np.concatenate([np.full(len(r), i) for i, r in enumerate(radii)])
    return np.concatenate(centres), np.concatenate(radii), levels


def _y_up(p) -> np.ndarray:
    p = np.asarray(p, np.float64).reshape(-1, 3)
    return np.stack([p[:, 0], p[:, 2], -p[:, 1]], 1)


def _unit(v) -> np.ndarray:
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


def camera(cfg: dict) -> dict:
    """The NFF view as a CENG477 camera (y-up)."""
    s = cfg["scene"]
    v = s["view"]
    eye, at, up = (_y_up(v[k])[0] for k in ("from", "at", "up"))
    gaze = _unit(at - eye)
    up = _unit(up - up.dot(gaze) * gaze)
    half = float(np.tan(np.radians(v["angle_deg"]) / 2.0))
    return {"position": eye.tolist(), "gaze": gaze.tolist(),
            "up": up.tolist(), "near_plane": [-half, half, -half, half],
            "near_distance": 1.0, "width": s["width"], "height": s["height"],
            "image_name": "flake66k.ppm"}


def generate(seed: int, cfg: dict) -> dict:
    s = cfg["scene"]
    centres, radii, _ = flake(cfg)
    n = len(radii)
    order = np.random.default_rng(abs(seed)).permutation(n)
    centres, radii = _y_up(centres[order]), radii[order]
    h, z = s["ground_half_side"], s["ground_z"]
    ground = _y_up([[-h, -h, z], [h, -h, z], [h, h, z], [-h, h, z]])
    verts = np.concatenate([ground, centres])
    # material 1: the spheres' (mirror); 2: the ground's.  Faces wind
    # counter-clockwise seen from above, so the ground's normal is +y.
    faces = np.array([[1, 2, 3], [1, 3, 4]])
    return {
        "background": s["background"],
        "shadow_eps": s["shadow_eps"],
        "max_depth": s["max_depth"],
        "cameras": [camera(cfg)],
        "ambient_light": s["ambient_light"],
        "point_lights": [(_y_up(l["position"])[0].tolist(), l["intensity"])
                         for l in s["point_lights"]],
        "materials": s["materials"],
        "vertices": verts.ravel().tolist(),
        "meshes": [(2, faces)],
        "triangles": [],
        # (material id, centre vertex id, radius), 1-based ids
        "spheres": [(1, 5 + i, float(radii[i])) for i in range(n)],
    }
