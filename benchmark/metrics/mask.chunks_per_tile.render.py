"""The hierarchical cluster mask's chunks per tile: the stretch's
``mask.chunks`` samples (the live (tile, 128-cluster chunk) pairs that
the supercluster pass hands ``ray_mask_hier``) over its ``mask.tiles``
(the active 128-ray tiles entering those mask calls).  None where the
program samples no ``mask.tiles`` (a scene whose masks are flat, or a
program without the counters)."""

from benchmark import port_spans


def read(trace):
    share = port_spans.sample_ratio(trace, "mask.chunks", "mask.tiles")
    return None if share is None else share / 100.0
