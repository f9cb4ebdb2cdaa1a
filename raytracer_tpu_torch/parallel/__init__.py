"""Parallel execution: the device mesh, sharded rendering, the process
group and the training step (inverse rendering, on one device or a
mesh)."""
