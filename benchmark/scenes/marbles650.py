"""The marbles field: 650 spheres on a jittered 26 x 25 grid (the layout of
the port's ``sphere_field``, frozen here), six mirror materials dealt to
the spheres in turn, two point lights, no triangles, one 1024x1024
camera.

``generate(seed, cfg)`` returns the parsed-scene dict that the XML writer
and the plain reference take.  The jitter of the centres and the radii
are drawn from the configuration's ``layout_seed`` inside fixed bounds
that keep every sphere apart from its neighbours, so every run traces
the same field; ``seed`` orders the spheres in the file and deals the
materials in that order.  The counts, materials, lights and camera are
the configuration's.
"""

from __future__ import annotations

import numpy as np


def generate(seed: int, cfg: dict) -> dict:
    s = cfg["scene"]
    nx, nz = s["grid"]
    n = nx * nz
    pitch = s["pitch"]
    rng = np.random.default_rng(s["layout_seed"])
    ii, jj = np.divmod(np.arange(n), nz)
    jit = s["jitter"] * pitch
    cx = (ii + 0.5 - nx / 2) * pitch + rng.uniform(-jit, jit, n)
    cz = (jj + 0.5 - nz / 2) * pitch + rng.uniform(-jit, jit, n)
    r_lo, r_hi = s["radius"]
    rad = pitch * rng.uniform(r_lo, r_hi, n)
    cy = rad + rng.random(n) * s["lift"] * pitch
    order = np.random.default_rng(abs(seed)).permutation(n)
    centers = np.stack([cx, cy, cz], axis=1)[order]
    rad = rad[order]
    n_mat = len(s["materials"])
    return {
        "background": s["background"],
        "shadow_eps": s["shadow_eps"],
        "max_depth": s["max_depth"],
        "cameras": [dict(s["camera"], width=s["width"], height=s["height"],
                         image_name="marbles650.ppm")],
        "ambient_light": s["ambient_light"],
        "point_lights": [(l["position"], l["intensity"])
                         for l in s["point_lights"]],
        "materials": s["materials"],
        "vertices": centers.ravel().tolist(),
        "meshes": [],
        "triangles": [],
        # (material id, centre vertex id, radius), 1-based ids
        "spheres": [(i % n_mat + 1, i + 1, float(rad[i])) for i in range(n)],
    }
