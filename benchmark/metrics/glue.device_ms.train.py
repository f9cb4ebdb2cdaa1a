"""Device ms per training step outside the port's kernels: the forward
glue, autograd (``index_add_``) and Adam."""

from benchmark.harness import device_ms_per


def read(trace):
    return device_ms_per(trace, "step", port=False)
