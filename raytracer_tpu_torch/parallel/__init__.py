"""Parallel execution: the device mesh, sharded rendering, the process
group and the training step (inverse rendering, on one device or a
mesh)."""

from raytracer_tpu_torch.parallel.mesh import make_mesh, replicate, shard_rays
from raytracer_tpu_torch.parallel.render import (
    render_camera_sharded, render_rays_sharded,
)
from raytracer_tpu_torch.parallel.train import (
    TrainState, apply_params, extract_params, init_state, make_train_step,
)

__all__ = [
    "make_mesh",
    "shard_rays",
    "replicate",
    "render_camera_sharded",
    "render_rays_sharded",
    "TrainState",
    "init_state",
    "extract_params",
    "apply_params",
    "make_train_step",
]
