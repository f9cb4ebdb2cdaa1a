"""Seconds of set-up in the port's kernel library load (``backend.load``:
the build when the library is missing, then the load)."""

from benchmark import port_spans


def read(trace):
    return port_spans.setup_s("backend")
