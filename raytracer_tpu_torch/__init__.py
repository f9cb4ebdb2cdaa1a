"""raytracer_tpu_torch: the Whitted ray tracer of ``raytracer_tpu`` on
PyTorch, with hand-written CUDA kernels for an NVIDIA H100 (sm_90a).

The port keeps the JAX package's module layout and names so that each
counterpart is easy to find; it never imports JAX or ``raytracer_tpu``.

- ``models``: scene, BVH and cluster builds (host numpy -> device
  tensors), the Whitted wavefront integrator (forward and
  differentiable).
- ``ops``: eye rays and their jitter (``camera``; ``random``, the port's
  copy of JAX's threefry key algebra), tile order, the brute and BVH engines
  (``traverse``, ``intersect``), the cluster engine's glue
  (``cluster_trace``) and its CUDA kernels with their plain PyTorch
  versions (``kernels``), shading and hit refinement, quantization and
  SSAA.
- ``parallel``: the device mesh (``mesh``: shards of the ray axis over
  the cards of a process, or logical shards of one device), sharded
  rendering (``render``), the ``torch.distributed`` bring-up and image
  gather (``distributed``), the scaling curve (``scaling``) and the
  training step (``train``: inverse rendering, on one device or a mesh).
- ``serve``: the warm render server (JSON lines on stdin or TCP, an LRU
  cache of scenes and accelerators on the card).
- ``utils``: XML ingest, PPM I/O, the native host library, synthetic
  scenes.
- ``backend``: device resolution and the kernel build.
- ``tracing``: the port's spans and counters (recorded while a
  ``torch.profiler`` records; set-up spans always), on the profiler's
  clock.

Entry points (``render.main``, ``train.main``, ``serve.main`` and
``serve.RenderServer``, ``pipeline.render_one_camera``,
``models.whitted.render_camera``, ``parallel.train.make_train_step``,
``parallel.mesh.mesh_from_arg``, ``parallel.scaling.measure_scaling``)
run on CUDA by default and raise without a GPU; ``device="cpu"`` selects
the plain versions.

The JAX package's library names are re-exported here, from ``ops`` and
from ``parallel``.  Importing them loads no kernel library (it is built at
the first launch) and no JAX.
"""

from raytracer_tpu_torch.models.bvh import BVH, build_bvh
from raytracer_tpu_torch.models.clusters import ClusterSet, build_clusters
from raytracer_tpu_torch.models.scene import Camera, SceneData, SceneMeta, load_scene
from raytracer_tpu_torch.models.whitted import render_camera, render_rays

__all__ = [
    "SceneData",
    "SceneMeta",
    "Camera",
    "load_scene",
    "BVH",
    "build_bvh",
    "ClusterSet",
    "build_clusters",
    "render_rays",
    "render_camera",
]

__version__ = "0.1.0"
