"""Percent of the kernels' lanes that trace a live ray: the stretch's
``wave.active`` samples (rays active entering a bounce) over its
``wave.lanes`` (128 x the live tiles the bounce's kernels see)."""

from benchmark import port_spans


def read(trace):
    return port_spans.sample_ratio(trace, "wave.active", "wave.lanes")
