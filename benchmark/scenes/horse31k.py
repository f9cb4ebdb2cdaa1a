"""The contest scene's counts on the horse-sized terrain: a frozen copy of
the port's ``terrain_scene`` (``utils/synth.py``) heightfield at
``cells=126``, cut to the published 31,582 triangles in 4 meshes (the
first cells of the last row are left out), with the published 6
materials (4 mirrors) and 2 spheres, at the contest's 2:1 camera
(1440x720).

The meshes: the diffuse terrain, and the mirror stripes (every
``mirror_every``-th row of cells) split by stripe among three mirror
materials.  The spheres (one diffuse, one mirror) stand on the terrain
in view; their centers are vertices after the heightfield's.

``generate(seed, cfg)`` returns the parsed-scene dict that the XML writer
(``benchmark/sceneio.py``) and the plain reference take: 1-based vertex
and material ids, meshes in file order.  The heightfield's noise is
drawn from ``seed``; its sizes, lights, materials, spheres and camera are
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

    # cells in row-major order (row i: x, column j: z); the last row's
    # first cells (the far right corner) are left out to reach the count
    row, col = np.divmod(np.arange(cells * cells), cells)
    keep = np.ones(cells * cells, bool)
    keep[(cells - 1) * cells:][:cells * cells - s["triangles"] // 2] = False
    row, col = row[keep], col[keep]
    a = row * n + col + 1
    b = a + 1
    c = a + n
    d = c + 1
    faces = np.empty((2 * len(a), 3), np.int64)
    faces[0::2] = np.stack([a, b, c], 1)
    faces[1::2] = np.stack([b, d, c], 1)
    row = np.repeat(row, 2)
    stripe = np.where(row % s["mirror_every"] == 0,
                      row // s["mirror_every"] % 3, -1)
    # the three mirror materials (2, 3, 4) first, then the diffuse one (1)
    meshes = [(2 + k, faces[stripe == k]) for k in range(3)]
    meshes.append((1, faces[stripe < 0]))

    centers = np.asarray([sp["center"] for sp in s["spheres"]], np.float64)
    first = len(verts) + 1
    spheres = [(sp["material"], first + i, sp["radius"])
               for i, sp in enumerate(s["spheres"])]
    cam = dict(s["camera"], width=s["width"], height=s["height"],
               image_name="horse31k.ppm")
    return {
        "background": s["background"],
        "shadow_eps": s["shadow_eps"],
        "max_depth": s["max_depth"],
        "cameras": [cam],
        "ambient_light": s["ambient_light"],
        "point_lights": [(l["position"], l["intensity"])
                         for l in s["point_lights"]],
        "materials": s["materials"],
        "vertices": np.concatenate([verts, centers]).ravel().tolist(),
        "meshes": meshes,
        "triangles": [],
        "spheres": spheres,
    }
