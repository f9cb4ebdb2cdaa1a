"""raytracer_tpu_torch: the Whitted ray tracer of ``raytracer_tpu`` on
PyTorch, with hand-written CUDA kernels for an NVIDIA H100 (sm_90a).

The port keeps the JAX package's module layout and names so that each
counterpart is easy to find; it never imports JAX or ``raytracer_tpu``.

- ``models``: scene, BVH and cluster builds (host numpy -> device
  tensors), the Whitted wavefront integrator (forward and
  differentiable).
- ``ops``: eye rays, tile order, the brute and BVH engines
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

Entry points (``render.main``, ``train.main``, ``serve.main`` and
``serve.RenderServer``, ``pipeline.render_one_camera``,
``models.whitted.render_camera``, ``parallel.train.make_train_step``,
``parallel.mesh.mesh_from_arg``, ``parallel.scaling.measure_scaling``)
run on CUDA by default and raise without a GPU; ``device="cpu"`` selects
the plain versions.
"""

__version__ = "0.1.0"
