"""Device ms per frame in the port's CUDA kernels (``csrc/*.cu``)."""

from benchmark.harness import device_ms_per


def read(trace):
    return device_ms_per(trace, "frame", port=True)
