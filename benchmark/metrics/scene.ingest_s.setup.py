"""Seconds of set-up in the port's scene ingest (``scene.ingest``: the
XML parse and the scene's tensors)."""

from benchmark import port_spans


def read(trace):
    return port_spans.setup_s("scene")
