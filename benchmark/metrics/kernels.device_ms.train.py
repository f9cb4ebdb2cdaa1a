"""Device ms per training step in the port's CUDA kernels."""

from benchmark.harness import device_ms_per


def read(trace):
    return device_ms_per(trace, "step", port=True)
