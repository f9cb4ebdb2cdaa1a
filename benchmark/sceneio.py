"""The benchmark's scenes: each configuration's generator
(``benchmark/scenes/<config>.py``) found by name, and the CENG477 XML
writer through which the program loads the scene as its users do."""

from __future__ import annotations

import numpy as np


def generate(bench, config: dict, seed: int) -> dict:
    """The parsed-scene dict of ``config`` for ``seed`` (``bench``: the
    ``paths.Bench`` whose ``scenes/`` holds its generator)."""
    return bench.load_module("scenes", config["name"]).generate(seed, config)


def _v(x) -> str:
    return " ".join(repr(float(t)) for t in x)


def write_xml(parsed: dict, path: str) -> None:
    """A CENG477 scene XML of ``parsed`` (1-based ids; floats as their
    shortest round-trip text, so the program's float32 parse and the
    reference's float32 cast of the same float64 numbers agree)."""
    cams = "".join(
        f'<Camera id="{i + 1}"><Position>{_v(c["position"])}</Position>'
        f'<Gaze>{_v(c["gaze"])}</Gaze><Up>{_v(c["up"])}</Up>'
        f'<NearPlane>{_v(c["near_plane"])}</NearPlane>'
        f'<NearDistance>{float(c["near_distance"])!r}</NearDistance>'
        f'<ImageResolution>{c["width"]} {c["height"]}</ImageResolution>'
        f'<ImageName>{c["image_name"]}</ImageName></Camera>\n'
        for i, c in enumerate(parsed["cameras"]))
    lights = "".join(
        f'<PointLight id="{i + 1}"><Position>{_v(p)}</Position>'
        f'<Intensity>{_v(q)}</Intensity></PointLight>\n'
        for i, (p, q) in enumerate(parsed["point_lights"]))
    mirror = ' type="mirror"'
    mats = "".join(
        f'<Material id="{i + 1}"{mirror if m["is_mirror"] else ""}>'
        f'<AmbientReflectance>{_v(m["ambient"])}</AmbientReflectance>'
        f'<DiffuseReflectance>{_v(m["diffuse"])}</DiffuseReflectance>'
        f'<SpecularReflectance>{_v(m["specular"])}</SpecularReflectance>'
        f'<MirrorReflectance>{_v(m["mirror"])}</MirrorReflectance>'
        f'<PhongExponent>{float(m["phong"])!r}</PhongExponent></Material>\n'
        for i, m in enumerate(parsed["materials"]))
    verts = "\n".join(_v(r) for r in
                      np.asarray(parsed["vertices"], np.float64).reshape(-1, 3))
    objects = []
    for i, (mat, faces) in enumerate(parsed["meshes"]):
        rows = "\n".join(" ".join(str(int(k)) for k in f) for f in faces)
        objects.append(f'<Mesh id="{i + 1}"><Material>{mat}</Material>'
                       f'<Faces>\n{rows}\n</Faces></Mesh>\n')
    for i, (mat, idx) in enumerate(parsed["triangles"]):
        objects.append(f'<Triangle id="{i + 1}"><Material>{mat}</Material>'
                       f'<Indices>{" ".join(str(int(k)) for k in idx)}'
                       '</Indices></Triangle>\n')
    for i, (mat, cvid, rad) in enumerate(parsed["spheres"]):
        objects.append(f'<Sphere id="{i + 1}"><Material>{mat}</Material>'
                       f'<Center>{int(cvid)}</Center>'
                       f'<Radius>{float(rad)!r}</Radius></Sphere>\n')
    background = " ".join(str(int(c)) for c in parsed["background"])
    with open(path, "w") as f:
        f.write(
            f'<Scene>\n<BackgroundColor>{background}</BackgroundColor>\n'
            f'<ShadowRayEpsilon>{float(parsed["shadow_eps"])!r}'
            '</ShadowRayEpsilon>\n'
            f'<MaxRecursionDepth>{int(parsed["max_depth"])}'
            '</MaxRecursionDepth>\n'
            f'<Cameras>\n{cams}</Cameras>\n<Lights>\n'
            f'<AmbientLight>{_v(parsed["ambient_light"])}</AmbientLight>\n'
            f'{lights}</Lights>\n<Materials>\n{mats}</Materials>\n'
            f'<VertexData>\n{verts}\n</VertexData>\n'
            f'<Objects>\n{"".join(objects)}</Objects>\n</Scene>\n')
