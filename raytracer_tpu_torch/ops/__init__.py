"""See the package docstring."""

from raytracer_tpu_torch.ops.camera import eye_rays
from raytracer_tpu_torch.ops.image import (
    downsample_mean, downsample_parity, quantize,
)
from raytracer_tpu_torch.ops.intersect import (
    aabb_intersect, sphere_intersect, tri_intersect,
)

__all__ = [
    "eye_rays",
    "tri_intersect",
    "sphere_intersect",
    "aabb_intersect",
    "quantize",
    "downsample_parity",
    "downsample_mean",
]
