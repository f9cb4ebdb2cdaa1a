"""CENG477 scene XML ingest (host-side, one-time cold path).

A copy of ``raytracer_tpu/utils/xml_ingest.py``: the port never imports
the JAX package, whose ``__init__`` pulls JAX in.

Semantics mirror the reference parser (the course's ``parser.cpp:6-218``,
format spec in hw1_v1.pdf §3/§7), using the stdlib ``xml.etree`` instead of a
vendored DOM library:

- ``BackgroundColor`` defaults to ``0 0 0`` and is parsed as integers
  (parser.h:256 stores a Vec3i).
- ``ShadowRayEpsilon`` defaults to 0.001, ``MaxRecursionDepth`` to 0
  (parser.cpp:36-57).
- A material is a mirror iff its element carries the attribute
  ``type="mirror"`` (parser.cpp:119).
- Sphere ``<Center>`` is a 1-based VERTEX id, not a coordinate
  (parser.h:200-204).
- All ids stay 1-based here; models.scene.from_parsed rebases to 0.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import List


def _floats(text: str) -> List[float]:
    return [float(tok) for tok in text.split()]


def _ints(text: str) -> List[int]:
    return [int(tok) for tok in text.split()]


def parse_xml(path: str) -> dict:
    root = ET.parse(path).getroot()

    def text_or(tag: str, default: str) -> str:
        el = root.find(tag)
        return el.text if el is not None and el.text is not None else default

    background = _ints(text_or("BackgroundColor", "0 0 0"))
    shadow_eps = float(text_or("ShadowRayEpsilon", "0.001"))
    max_depth = int(text_or("MaxRecursionDepth", "0"))

    cameras = []
    for cam in root.find("Cameras").findall("Camera"):
        res = _ints(cam.find("ImageResolution").text)
        cameras.append(
            {
                "position": _floats(cam.find("Position").text),
                "gaze": _floats(cam.find("Gaze").text),
                "up": _floats(cam.find("Up").text),
                "near_plane": _floats(cam.find("NearPlane").text),  # l r b t
                "near_distance": float(cam.find("NearDistance").text),
                "width": res[0],
                "height": res[1],
                "image_name": cam.find("ImageName").text.strip(),
            }
        )

    lights_el = root.find("Lights")
    ambient_light = _floats(lights_el.find("AmbientLight").text)
    point_lights = [
        (_floats(pl.find("Position").text), _floats(pl.find("Intensity").text))
        for pl in lights_el.findall("PointLight")
    ]

    materials = []
    for mat in root.find("Materials").findall("Material"):
        def mtext(tag: str, default: str) -> str:
            el = mat.find(tag)
            return el.text if el is not None and el.text is not None else default

        materials.append(
            {
                "is_mirror": mat.get("type") == "mirror",
                "ambient": _floats(mtext("AmbientReflectance", "0 0 0")),
                "diffuse": _floats(mtext("DiffuseReflectance", "0 0 0")),
                "specular": _floats(mtext("SpecularReflectance", "0 0 0")),
                # all bundled scenes specify MirrorReflectance explicitly;
                # tolerate its absence for non-mirror materials
                "mirror": _floats(mtext("MirrorReflectance", "0 0 0")),
                "phong": float(mtext("PhongExponent", "1")),
            }
        )

    vert_vals = _floats(root.find("VertexData").text)
    if len(vert_vals) % 3 != 0:
        raise ValueError(f"{path}: VertexData length not a multiple of 3")
    vertices = [vert_vals[i : i + 3] for i in range(0, len(vert_vals), 3)]

    objects = root.find("Objects")
    meshes = []
    triangles = []
    spheres = []
    if objects is not None:
        for mesh in objects.findall("Mesh"):
            mat_id = int(mesh.find("Material").text)
            face_vals = _ints(mesh.find("Faces").text)
            faces = [
                (face_vals[i], face_vals[i + 1], face_vals[i + 2])
                for i in range(0, len(face_vals), 3)
            ]
            meshes.append((mat_id, faces))
        for tri in objects.findall("Triangle"):
            mat_id = int(tri.find("Material").text)
            idx = _ints(tri.find("Indices").text)
            triangles.append((mat_id, (idx[0], idx[1], idx[2])))
        for sph in objects.findall("Sphere"):
            spheres.append(
                (
                    int(sph.find("Material").text),
                    int(sph.find("Center").text),
                    float(sph.find("Radius").text),
                )
            )

    return {
        "background": background,
        "shadow_eps": shadow_eps,
        "max_depth": max_depth,
        "cameras": cameras,
        "ambient_light": ambient_light,
        "point_lights": point_lights,
        "materials": materials,
        "vertices": vertices,
        "meshes": meshes,
        "triangles": triangles,
        "spheres": spheres,
    }
