"""Percent of the hierarchical route's shortlists that overflow: the
stretch's ``lists.over`` samples (the (tile, list) shortlists whose count
passed ``MAX_TRI_LIST`` / ``MAX_SPH_LIST``, which the visiting kernels
walk as the tile's bitmask) over its ``lists.tiles`` (the shortlists with
a candidate that the compactions built).  None where the program samples
no ``lists.tiles`` (a scene whose masks are flat, or a program without
the counters)."""

from benchmark import port_spans


def read(trace):
    return port_spans.sample_ratio(trace, "lists.over", "lists.tiles")
