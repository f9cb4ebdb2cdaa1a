"""Seconds of set-up in the port's accelerator build (``accel.build``:
the BVH and clusters on the host, their upload)."""

from benchmark import port_spans


def read(trace):
    return port_spans.setup_s("accel")
