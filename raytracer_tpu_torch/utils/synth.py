"""Synthetic scene generation (a copy of ``raytracer_tpu/utils/synth.py``
with a ``device`` argument): scenes at any size without the bundled
CENG477 inputs, whose largest mesh is horse_and_mug's 31.6k triangles.

``terrain_scene(cells)`` builds a displaced-heightfield mesh with
2*cells^2 triangles through the SAME ingestion path as XML scenes
(models.scene.from_parsed), so every engine/accelerator treats it like
any other scene.  ``terrain_scene(cells=126, res=1024,
mirror_stripes=True)`` matches horse_and_mug's size: 31,752 triangles,
two lights, mirror bounces, 1,048,576 primary rays at SSAA 1.
"""

from __future__ import annotations

import numpy as np

from raytracer_tpu_torch.models.scene import from_parsed


def terrain_scene(cells: int = 500, extent: float = 100.0,
                  res: int = 512, seed: int = 0,
                  max_depth: int = 2, mirror_stripes: bool = False,
                  device="cuda"):
    """(data, meta) for a (cells+1)^2-vertex displaced terrain.

    The heightfield mixes smooth waves with per-vertex noise so the BVH
    (and the cluster boxes derived from its preorder) sees realistic
    spatially-varying density.  ``mirror_stripes`` marks every 7th
    column's material mirror to exercise deep bounces at scale.
    """
    rng = np.random.default_rng(seed)
    n = cells + 1
    xs = np.linspace(-extent / 2, extent / 2, n)
    zs = np.linspace(-extent / 2, extent / 2, n)
    xg, zg = np.meshgrid(xs, zs, indexing="ij")
    y = (4.0 * np.sin(xg / 7.0) * np.cos(zg / 9.0)
         + 1.5 * np.sin(xg / 2.3 + 1.0) * np.sin(zg / 3.1)
         + rng.normal(0, 0.15, xg.shape))
    verts = np.stack([xg, y, zg], axis=-1).reshape(-1, 3)

    # two triangles per cell; 1-based vertex ids (from_parsed converts)
    i0 = (np.arange(cells)[:, None] * n + np.arange(cells)[None, :])
    a = i0.ravel() + 1
    b = a + 1
    c = a + n
    d = c + 1
    faces = np.empty((2 * cells * cells, 3), np.int64)
    faces[0::2] = np.stack([a, b, c], 1)
    faces[1::2] = np.stack([b, d, c], 1)

    mat_diffuse = {
        "is_mirror": False,
        "ambient": [0.1, 0.1, 0.1],
        "diffuse": [0.7, 0.6, 0.5],
        "specular": [0.2, 0.2, 0.2],
        "mirror": [0.0, 0.0, 0.0],
        "phong": 20.0,
    }
    materials = [mat_diffuse]
    meshes = []
    if mirror_stripes:
        materials.append({
            "is_mirror": True,
            "ambient": [0.05, 0.05, 0.05],
            "diffuse": [0.2, 0.2, 0.25],
            "specular": [0.3, 0.3, 0.3],
            "mirror": [0.6, 0.6, 0.65],
            "phong": 60.0,
        })
        col = (np.arange(faces.shape[0]) // (2 * cells)) % 7 == 0
        meshes.append((2, [tuple(f) for f in faces[col]]))
        meshes.append((1, [tuple(f) for f in faces[~col]]))
    else:
        meshes.append((1, [tuple(f) for f in faces]))

    parsed = {
        "background": [20, 30, 60],
        "shadow_eps": 1e-3,
        "max_depth": max_depth,
        "cameras": [{
            "position": [0.0, 35.0, extent * 0.75],
            "gaze": [0.0, -0.45, -1.0],
            "up": [0.0, 1.0, 0.0],  # used verbatim (no Gram-Schmidt),
            "near_plane": [-1.0, 1.0, -1.0, 1.0],  # like the reference
            "near_distance": 1.0,
            "width": res,
            "height": res,
            "image_name": "terrain.ppm",
        }],
        "ambient_light": [40.0, 40.0, 40.0],
        "point_lights": [
            ([0.0, 60.0, 0.0], [2.5e5, 2.5e5, 2.4e5]),
            ([extent / 2, 40.0, extent / 2], [1.2e5, 1.1e5, 1.0e5]),
        ],
        "materials": materials,
        "vertices": verts.ravel().tolist(),
        "meshes": meshes,
        "triangles": [],
        "spheres": [],
    }
    return from_parsed(parsed, device)


def sphere_field(n_spheres: int = 20000, extent: float = 100.0,
                 res: int = 512, seed: int = 0, max_depth: int = 2,
                 device="cuda"):
    """(data, meta) for a jittered grid of ``n_spheres`` spheres — the
    marbles regime at scale (sphere-cluster heavy, no triangles).
    Radii vary 2x so cluster boxes see non-uniform density."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n_spheres)))
    pitch = extent / side
    ii, jj = np.divmod(np.arange(n_spheres), side)
    cx = (ii + 0.5) * pitch - extent / 2 + rng.normal(0, 0.2 * pitch,
                                                      n_spheres)
    cz = (jj + 0.5) * pitch - extent / 2 + rng.normal(0, 0.2 * pitch,
                                                      n_spheres)
    rad = pitch * (0.2 + 0.2 * rng.random(n_spheres))
    cy = rad + rng.random(n_spheres) * 0.5 * pitch
    centers = np.stack([cx, cy, cz], axis=1)
    parsed = {
        "background": [15, 20, 40],
        "shadow_eps": 1e-3,
        "max_depth": max_depth,
        "cameras": [{
            "position": [0.0, extent * 0.4, extent * 0.8],
            "gaze": [0.0, -0.4, -1.0],
            "up": [0.0, 1.0, 0.0],
            "near_plane": [-1.0, 1.0, -1.0, 1.0],
            "near_distance": 1.0,
            "width": res,
            "height": res,
            "image_name": "sphere_field.ppm",
        }],
        "ambient_light": [30.0, 30.0, 30.0],
        "point_lights": [
            ([0.0, extent, 0.0], [3e5, 3e5, 2.8e5]),
        ],
        "materials": [{
            "is_mirror": False,
            "ambient": [0.1, 0.1, 0.1],
            "diffuse": [0.6, 0.55, 0.5],
            "specular": [0.3, 0.3, 0.3],
            "mirror": [0.0, 0.0, 0.0],
            "phong": 30.0,
        }],
        "vertices": centers.ravel().tolist(),
        "meshes": [],
        "triangles": [],
        # sphere center is a 1-based VERTEX id (parser.h:200-204)
        "spheres": [(1, i + 1, float(rad[i])) for i in range(n_spheres)],
    }
    return from_parsed(parsed, device)
