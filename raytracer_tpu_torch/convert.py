"""Host arrays -> the port's device structures.

``scene_from_numpy`` and ``clusters_from_numpy`` take a mapping of field
name -> numpy array (for the clusters also the ints ``n_tri`` and
``n_sph``) and return the port's ``SceneData`` / ``ClusterSet`` on
``device``.  The host builds use them, and so do the tests, which hand
the JAX package's structures across field by field (``np.asarray`` on
each) so that both packages trace the very same accelerator.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from raytracer_tpu_torch.backend import resolve_device
from raytracer_tpu_torch.models.clusters import ClusterSet
from raytracer_tpu_torch.models.scene import SceneData


def _tensors(cls, fields: Mapping, dev: torch.device) -> dict:
    return {
        f.name: torch.from_numpy(np.ascontiguousarray(fields[f.name])).to(dev)
        for f in dataclasses.fields(cls) if f.type != "int"
    }


def scene_from_numpy(fields: Mapping, device="cuda") -> SceneData:
    """SceneData on ``device`` from numpy arrays keyed by field name."""
    return SceneData(**_tensors(SceneData, fields, resolve_device(device)))


def clusters_from_numpy(fields: Mapping, device="cuda") -> ClusterSet:
    """ClusterSet on ``device`` from numpy arrays keyed by field name plus
    the real primitive counts ``n_tri`` and ``n_sph``."""
    return ClusterSet(**_tensors(ClusterSet, fields, resolve_device(device)),
                      n_tri=int(fields["n_tri"]), n_sph=int(fields["n_sph"]))
