"""Persistence in the JAX package's file layouts (port of
``raytracer_tpu/utils/checkpoint.py``), so a file written by either
package loads in the other.

- **The accel cache**: a scene's BVH and cluster set saved as one npz, so
  a repeated render skips the build.  Version 5: ``accel_version``, then
  every field under its own key, ``bvh.<field>`` and ``cluster.<field>``
  (the cluster counts ``n_tri``/``n_sph`` as int64 scalars); the BVH's
  optional octant threads (``bvh.oct_*``) are written when present and
  loaded when the file has them.  The port also stores ``scene_digest``,
  a sha1 of the scene arrays the build reads (the JAX loader ignores the
  key), and a load given a digest accepts only a file saved with the
  same one.
- **Train-state checkpoints** of inverse rendering (``parallel.train``):
  the leaves of the JAX package's ``TrainState(params, optax.adam state)``
  in its tree order as ``leaf_0`` ... ``leaf_n``: the params sorted by
  field name, then adam's ``count`` (shape ``()``, int32), then ``mu``
  and ``nu``, each sorted by field name.  ``count`` is Adam's ``step``,
  ``mu`` its ``exp_avg`` and ``nu`` its ``exp_avg_sq``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import zipfile
import zlib
from typing import Optional, Tuple

import numpy as np

from raytracer_tpu_torch.models.bvh import BVH, OCT_FIELDS
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
        v = getattr(bvh, f.name)
        if v is not None:
            payload[f"bvh.{f.name}"] = np.asarray(v)
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
                         for f in dataclasses.fields(BVH)
                         if f"bvh.{f.name}" in z.files
                         or f.name not in OCT_FIELDS})
            fields = {f.name: z[f"cluster.{f.name}"]
                      for f in dataclasses.fields(ClusterSet)}
    except (OSError, EOFError, KeyError, zipfile.BadZipFile, zlib.error) as e:
        raise ValueError(f"{path}: unreadable accel cache ({e})") from e
    return bvh, clusters_from_numpy(fields, device)


def _train_leaves(params, count, mu, nu) -> list:
    """The JAX TrainState's leaves in its tree order."""
    names = sorted(params)
    return ([params[n] for n in names] + [count] + [mu[n] for n in names]
            + [nu[n] for n in names])


def save_train_state(path: str, state) -> None:
    """Write a ``parallel.train.TrainState`` to ``path`` in the JAX
    package's layout (``leaf_i``, module docstring)."""
    from raytracer_tpu_torch.convert import train_state_to_numpy

    params, count, mu, nu = train_state_to_numpy(state)
    leaves = _train_leaves(params, np.asarray(count, np.int32), mu, nu)
    payload = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)}
    with open(path, "wb") as f:
        np.savez_compressed(f, **payload)


def load_train_state(path: str, state_like):
    """The TrainState saved at ``path`` (by either package), shaped and
    placed like ``state_like`` (e.g. a fresh ``init_state``).  Raises ValueError when a leaf's shape differs."""
    from raytracer_tpu_torch.convert import train_state_from_numpy

    names = sorted(state_like.params)
    shapes = {n: tuple(state_like.params[n].shape) for n in names}
    want = _train_leaves(shapes, (), shapes, shapes)
    with np.load(path) as z:
        loaded = [z[f"leaf_{i}"] for i in range(len(want))]
    for got, shape in zip(loaded, want):
        if got.shape != tuple(shape):
            raise ValueError(
                f"{path}: leaf shape {got.shape} != expected {tuple(shape)}")
    n = len(names)
    params = dict(zip(names, loaded[:n]))
    mu = dict(zip(names, loaded[n + 1:2 * n + 1]))
    nu = dict(zip(names, loaded[2 * n + 1:]))
    # the state's own field order (its optimizer's parameter order)
    order = list(state_like.params)
    p = next(iter(state_like.params.values()))
    return train_state_from_numpy(
        {f: params[f] for f in order}, loaded[n], mu, nu, device=p.device)
