"""Host arrays -> the port's device structures.

``scene_from_numpy`` and ``clusters_from_numpy`` take a mapping of field
name -> numpy array (for the clusters also the ints ``n_tri`` and
``n_sph``) and return the port's ``SceneData`` / ``ClusterSet`` on
``device``.  The host builds use them, and so do the tests, which hand
the JAX package's structures across field by field (``np.asarray`` on
each) so that both packages trace the very same accelerator.

``train_state_from_numpy`` and ``train_state_to_numpy`` carry a training
state across: the JAX package's ``TrainState(params, optax.adam state)``
as numpy arrays (params, adam's ``count``, ``mu``, ``nu``) to and from
the port's ``parallel.train.TrainState`` (``count`` is Adam's ``step``,
``mu`` its ``exp_avg``, ``nu`` its ``exp_avg_sq``).
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


def train_state_from_numpy(params: Mapping, count, mu: Mapping, nu: Mapping,
                           device="cuda"):
    """The port's TrainState on ``device`` from numpy arrays: ``params``,
    ``mu`` and ``nu`` keyed by field name, ``count`` the optax step count
    (shape ``()``); its Adam is ``init_state``'s kind (capturable on a
    CUDA device)."""
    from raytracer_tpu_torch.parallel.train import TrainState, _adam

    dev = resolve_device(device)

    def tensor(x):
        return torch.from_numpy(np.array(x, np.float32)).to(dev)

    leaves = {f: tensor(v).requires_grad_(True) for f, v in params.items()}
    opt = _adam(list(leaves.values()))
    # capturable Adam (on the card) keeps its step count on the params'
    # device, plain Adam on the CPU
    step_dev = dev if opt.param_groups[0]["capturable"] else "cpu"
    for f, p in leaves.items():
        opt.state[p] = {"step": torch.tensor(float(np.asarray(count)),
                                             dtype=torch.float32,
                                             device=step_dev),
                        "exp_avg": tensor(mu[f]), "exp_avg_sq": tensor(nu[f])}
    return TrainState(leaves, opt)


def train_state_to_numpy(state):
    """(params, count, mu, nu) of a port TrainState as numpy arrays, the
    JAX package's adam state (zeros and count 0 before the first step)."""
    params, mu, nu = {}, {}, {}
    count = np.int32(0)
    for f, p in state.params.items():
        params[f] = p.detach().cpu().numpy()
        st = state.opt.state.get(p, {})
        if st:
            count = np.int32(int(st["step"]))
        mu[f] = (st["exp_avg"].cpu().numpy() if st
                 else np.zeros_like(params[f]))
        nu[f] = (st["exp_avg_sq"].cpu().numpy() if st
                 else np.zeros_like(params[f]))
    return params, count, mu, nu
