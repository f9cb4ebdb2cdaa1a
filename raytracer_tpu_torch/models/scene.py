"""Scene data model: a frozen dataclass of tensors on one device.

Port of ``raytracer_tpu/models/scene.py``: the same flattened
struct-of-arrays scene (lone ``<Triangle>`` objects first, then every
mesh's faces in file order; 0-based ids; primitive axes padded to a
multiple of ``pad_multiple``), held as PyTorch tensors on ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from raytracer_tpu_torch import tracing


@dataclasses.dataclass(frozen=True)
class SceneData:
    """All per-primitive scene state; shapes use padded sizes V, T, S, M,
    L and the ``*_valid`` masks mark real entries."""

    vertices: torch.Tensor        # (V, 3) f32
    tri_v: torch.Tensor           # (T, 3) i32, 0-based vertex indices
    tri_mat: torch.Tensor         # (T,)   i32, 0-based material index
    tri_valid: torch.Tensor       # (T,)   bool
    sphere_cvid: torch.Tensor     # (S,)   i32, vertex index of the center
    sphere_rad: torch.Tensor      # (S,)   f32
    sphere_mat: torch.Tensor      # (S,)   i32
    sphere_valid: torch.Tensor    # (S,)   bool
    mat_ambient: torch.Tensor     # (M, 3) f32
    mat_diffuse: torch.Tensor     # (M, 3) f32
    mat_specular: torch.Tensor    # (M, 3) f32
    mat_mirror: torch.Tensor      # (M, 3) f32
    mat_phong: torch.Tensor       # (M,)   f32
    mat_is_mirror: torch.Tensor   # (M,)   bool, XML attribute type="mirror"
    light_pos: torch.Tensor       # (L, 3) f32
    light_int: torch.Tensor       # (L, 3) f32
    light_valid: torch.Tensor     # (L,)   bool
    ambient_light: torch.Tensor   # (3,)   f32
    background: torch.Tensor      # (3,)   f32, parsed as ints

    @property
    def device(self) -> torch.device:
        return self.vertices.device

    def to(self, device) -> "SceneData":
        return tensors_to(self, device)


def tensors_to(obj, device):
    """The frozen dataclass ``obj`` with every tensor field moved to
    ``device`` by ``Tensor.to`` (so a field already there is kept, not
    copied, and a move keeps the autograd graph); ``obj`` itself when
    nothing moves."""
    device = torch.device(device)
    moved = {f.name: getattr(obj, f.name).to(device)
             for f in dataclasses.fields(obj)
             if isinstance(getattr(obj, f.name), torch.Tensor)
             and getattr(obj, f.name).device != device}
    return dataclasses.replace(obj, **moved) if moved else obj


@dataclasses.dataclass(frozen=True)
class Camera:
    """Per-render camera config; ``near_plane`` is (l, r, b, t).  Position,
    gaze and up are used verbatim (no re-orthonormalization)."""

    position: Tuple[float, float, float]
    gaze: Tuple[float, float, float]
    up: Tuple[float, float, float]
    near_plane: Tuple[float, float, float, float]
    near_distance: float
    width: int
    height: int
    image_name: str

    def scaled(self, factor: int) -> "Camera":
        """Camera with resolution multiplied by ``factor`` (SSAA prepass)."""
        return dataclasses.replace(
            self, width=self.width * factor, height=self.height * factor
        )


@dataclasses.dataclass(frozen=True)
class SceneMeta:
    """Static scene config: loop bounds and true counts."""

    shadow_eps: float
    max_depth: int
    cameras: Tuple[Camera, ...]
    n_verts: int
    n_tris: int
    n_spheres: int
    n_materials: int
    n_lights: int


def _pad_to(arr: np.ndarray, n: int, fill=0) -> np.ndarray:
    if arr.shape[0] == n:
        return arr
    pad_shape = (n - arr.shape[0],) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, dtype=arr.dtype)], axis=0)


def _round_up(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


def scene_arrays(parsed: dict, pad_multiple: int = 8):
    """(fields, meta): the SceneData fields as numpy arrays, built from the
    dict of ``utils.xml_ingest.parse_xml``."""
    verts = np.asarray(parsed["vertices"], dtype=np.float32).reshape(-1, 3)
    V = max(1, verts.shape[0])
    verts = _pad_to(verts, V)

    tri_v: List[Tuple[int, int, int]] = []
    tri_mat: List[int] = []
    for mat_id, (i0, i1, i2) in parsed["triangles"]:
        tri_v.append((i0 - 1, i1 - 1, i2 - 1))
        tri_mat.append(mat_id - 1)
    for mat_id, faces in parsed["meshes"]:
        for (i0, i1, i2) in faces:
            tri_v.append((i0 - 1, i1 - 1, i2 - 1))
            tri_mat.append(mat_id - 1)
    n_tris = len(tri_v)
    T = _round_up(n_tris, pad_multiple)

    spheres = parsed["spheres"]  # (mat_id, center_vid, radius)
    n_spheres = len(spheres)
    S = _round_up(n_spheres, pad_multiple)

    mats = parsed["materials"]
    n_mats = len(mats)
    M = max(1, n_mats)

    def mat_field(key, dim):
        a = np.asarray([m[key] for m in mats], dtype=np.float32).reshape(n_mats, dim)
        return _pad_to(a, M)

    lights = parsed["point_lights"]  # (pos, intensity)
    n_lights = len(lights)
    L = max(1, n_lights)

    fields = dict(
        vertices=verts,
        tri_v=_pad_to(np.asarray(tri_v, dtype=np.int32).reshape(-1, 3), T),
        tri_mat=_pad_to(np.asarray(tri_mat, dtype=np.int32).reshape(-1), T),
        tri_valid=np.arange(T) < n_tris,
        sphere_cvid=_pad_to(np.asarray([s[1] - 1 for s in spheres],
                                       dtype=np.int32).reshape(-1), S),
        sphere_rad=_pad_to(np.asarray([s[2] for s in spheres],
                                      dtype=np.float32).reshape(-1), S),
        sphere_mat=_pad_to(np.asarray([s[0] - 1 for s in spheres],
                                      dtype=np.int32).reshape(-1), S),
        sphere_valid=np.arange(S) < n_spheres,
        mat_ambient=mat_field("ambient", 3),
        mat_diffuse=mat_field("diffuse", 3),
        mat_specular=mat_field("specular", 3),
        mat_mirror=mat_field("mirror", 3),
        mat_phong=_pad_to(np.asarray([m["phong"] for m in mats],
                                     dtype=np.float32).reshape(-1), M),
        mat_is_mirror=_pad_to(np.asarray([m["is_mirror"] for m in mats],
                                         dtype=bool).reshape(-1), M, fill=False),
        light_pos=_pad_to(np.asarray([l[0] for l in lights],
                                     dtype=np.float32).reshape(n_lights, 3), L),
        light_int=_pad_to(np.asarray([l[1] for l in lights],
                                     dtype=np.float32).reshape(n_lights, 3), L),
        light_valid=np.arange(L) < n_lights,
        ambient_light=np.asarray(parsed["ambient_light"], dtype=np.float32),
        background=np.asarray(parsed["background"], dtype=np.float32),
    )
    cameras = tuple(
        Camera(
            position=tuple(c["position"]),
            gaze=tuple(c["gaze"]),
            up=tuple(c["up"]),
            near_plane=tuple(c["near_plane"]),
            near_distance=c["near_distance"],
            width=c["width"],
            height=c["height"],
            image_name=c["image_name"],
        )
        for c in parsed["cameras"]
    )
    meta = SceneMeta(
        shadow_eps=float(parsed["shadow_eps"]),
        max_depth=int(parsed["max_depth"]),
        cameras=cameras,
        n_verts=verts.shape[0],
        n_tris=n_tris,
        n_spheres=n_spheres,
        n_materials=n_mats,
        n_lights=n_lights,
    )
    return fields, meta


def from_parsed(parsed: dict, device="cuda", pad_multiple: int = 8
                ) -> Tuple[SceneData, SceneMeta]:
    """Build (SceneData on ``device``, SceneMeta) from a parsed scene dict."""
    from raytracer_tpu_torch.convert import scene_from_numpy

    fields, meta = scene_arrays(parsed, pad_multiple)
    return scene_from_numpy(fields, device), meta


def load_scene(path: str, device="cuda", pad_multiple: int = 8
               ) -> Tuple[SceneData, SceneMeta]:
    """Parse a CENG477 scene XML into (SceneData, SceneMeta) (the set-up
    span ``scene.ingest``)."""
    from raytracer_tpu_torch.utils.xml_ingest import parse_xml

    with tracing.setup_span("scene.ingest"):
        return from_parsed(parse_xml(path), device, pad_multiple)
