"""Device ms per frame in every device operation but the port's kernels:
the glue and integrator (sorts, gathers, shading, copies)."""

from benchmark.harness import device_ms_per


def read(trace):
    return device_ms_per(trace, "frame", port=False)
