"""Percent of the port kernels' device time per frame that their
roofline bound needs: the bound summed over one eager frame's kernel
calls (``roofline.Recorder``) over the port kernels' device ms per
replayed frame of the traced stretch."""

from benchmark.harness import device_ms_per


def read(trace):
    bound = trace.counters.get("roofline_bound_ms")
    ms = device_ms_per(trace, "frame", port=True)
    if not bound or not ms:
        return None
    return 100.0 * bound / ms
