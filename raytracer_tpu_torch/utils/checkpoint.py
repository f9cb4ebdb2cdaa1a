"""The accel cache: a scene's BVH and cluster set saved as one npz, so a
repeated render skips the build (the accel half of
``raytracer_tpu/utils/checkpoint.py``).

The layout is the JAX package's, version 5: ``accel_version``, then every
field under its own key, ``bvh.<field>`` and ``cluster.<field>`` (the
cluster counts ``n_tri``/``n_sph`` as int64 scalars).  The port's BVH has
no octant threads (``bvh.oct_*``): it writes none and ignores them when a
JAX-written file has them.  So a cache written by either package loads in
the other.  The port also stores ``scene_digest``, a sha1 of the scene
arrays the build reads (the JAX loader ignores the key), and a load given
a digest accepts only a file saved with the same one.
"""

from __future__ import annotations

import dataclasses
import hashlib
import zipfile
import zlib
from typing import Optional, Tuple

import numpy as np

from raytracer_tpu_torch.models.bvh import BVH
from raytracer_tpu_torch.models.clusters import ClusterSet

_ACCEL_VERSION = 5

# the scene arrays that build_bvh and build_clusters read
_DIGEST_FIELDS = ("vertices", "tri_v", "tri_mat", "sphere_cvid",
                  "sphere_rad", "sphere_mat")


def scene_digest(data) -> str:
    """sha1 (hex) of the scene arrays the BVH and cluster build read, with
    their shapes and dtypes."""
    h = hashlib.sha1()
    for name in _DIGEST_FIELDS:
        a = np.ascontiguousarray(getattr(data, name).cpu().numpy())
        h.update(f"{name}{a.shape}{a.dtype}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def save_accel(path: str, bvh: BVH, clusters: ClusterSet,
               digest: Optional[str] = None) -> None:
    """Write the scene's acceleration structures to ``path``, with the
    scene's ``scene_digest`` when given."""
    payload: dict = {"accel_version": np.int64(_ACCEL_VERSION)}
    if digest is not None:
        payload["scene_digest"] = np.array(digest)
    for f in dataclasses.fields(BVH):
        payload[f"bvh.{f.name}"] = np.asarray(getattr(bvh, f.name))
    for f in dataclasses.fields(ClusterSet):
        v = getattr(clusters, f.name)
        payload[f"cluster.{f.name}"] = (
            np.int64(v) if isinstance(v, int) else v.cpu().numpy())
    # an open file keeps numpy from appending '.npz' to a bare path
    with open(path, "wb") as f:
        np.savez_compressed(f, **payload)


def load_accel(path: str, device="cuda",
               digest: Optional[str] = None) -> Tuple[BVH, ClusterSet]:
    """(bvh, clusters) from a ``save_accel`` file: the BVH as numpy arrays,
    the clusters as tensors on ``device``.  Raises ValueError for a file
    that is not a readable version-5 accel cache, and, when ``digest`` is
    given, for one not saved with that scene digest."""
    from raytracer_tpu_torch.convert import clusters_from_numpy

    try:
        with np.load(path) as z:
            if "accel_version" not in z.files or int(
                    z["accel_version"]) != _ACCEL_VERSION:
                raise ValueError(
                    f"{path}: not a version-{_ACCEL_VERSION} accel cache")
            if digest is not None and (
                    "scene_digest" not in z.files
                    or str(z["scene_digest"]) != digest):
                raise ValueError(f"{path}: saved for another scene (or "
                                 "without a scene digest)")
            bvh = BVH(**{f.name: z[f"bvh.{f.name}"]
                         for f in dataclasses.fields(BVH)})
            fields = {f.name: z[f"cluster.{f.name}"]
                      for f in dataclasses.fields(ClusterSet)}
    except (OSError, EOFError, KeyError, zipfile.BadZipFile, zlib.error) as e:
        raise ValueError(f"{path}: unreadable accel cache ({e})") from e
    return bvh, clusters_from_numpy(fields, device)
