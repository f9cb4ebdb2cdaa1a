"""The port's big scene: a frozen copy of the port's ``terrain_scene``
(``utils/synth.py``) heightfield at ``cells=512``, ``res=1024``,
``mirror_stripes=True``, the scene ``chip_smoke.py``'s phase 3b renders:
524,288 triangles (4,096 clusters of 128) in 2 meshes, the mirror
stripes (every ``mirror_every``-th row of cells) and the diffuse rest,
2 materials, 2 point lights, max depth 2, 1024x1024.

At this size every exact cluster mask takes the hierarchical route, the
per-light shadow plane tables exceed their budget (every shadow ray goes
to the any-hit kernel), and the port caps a band at 131,072 rays.

``generate(seed, cfg)`` returns the parsed-scene dict that the XML writer
(``benchmark/sceneio.py``) and the plain reference take: 1-based vertex
and material ids, meshes in ``terrain_scene``'s order.  The heightfield's
noise is drawn from ``seed``; its sizes, lights, materials and camera are
the configuration's and do not depend on it.
"""

from __future__ import annotations

import numpy as np


def generate(seed: int, cfg: dict) -> dict:
    s = cfg["scene"]
    cells, extent = s["cells"], s["extent"]
    rng = np.random.default_rng(abs(seed))
    n = cells + 1
    xs = np.linspace(-extent / 2, extent / 2, n)
    zs = np.linspace(-extent / 2, extent / 2, n)
    xg, zg = np.meshgrid(xs, zs, indexing="ij")
    y = (4.0 * np.sin(xg / 7.0) * np.cos(zg / 9.0)
         + 1.5 * np.sin(xg / 2.3 + 1.0) * np.sin(zg / 3.1)
         + rng.normal(0, s["noise"], xg.shape))
    verts = np.stack([xg, y, zg], axis=-1).reshape(-1, 3)

    # two triangles per cell, cells in row-major order (row i: x)
    a = (np.arange(cells)[:, None] * n + np.arange(cells)[None, :]).ravel() + 1
    b = a + 1
    c = a + n
    d = c + 1
    faces = np.empty((2 * cells * cells, 3), np.int64)
    faces[0::2] = np.stack([a, b, c], 1)
    faces[1::2] = np.stack([b, d, c], 1)
    mirror = np.arange(len(faces)) // (2 * cells) % s["mirror_every"] == 0
    cam = dict(s["camera"], width=s["width"], height=s["height"],
               image_name="terrain524k.ppm")
    return {
        "background": s["background"],
        "shadow_eps": s["shadow_eps"],
        "max_depth": s["max_depth"],
        "cameras": [cam],
        "ambient_light": s["ambient_light"],
        "point_lights": [(l["position"], l["intensity"])
                         for l in s["point_lights"]],
        "materials": s["materials"],
        "vertices": verts.ravel().tolist(),
        # the mirror material (2) first, then the diffuse one (1)
        "meshes": [(2, faces[mirror]), (1, faces[~mirror])],
        "triangles": [],
        "spheres": [],
    }
