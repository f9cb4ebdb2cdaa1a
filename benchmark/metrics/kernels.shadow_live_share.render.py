"""Percent of the shadow kernel's sphere-walk ray slots that start live:
the stretch's ``shadow.live`` samples (the rays active toward the light
and not occluded by a triangle as a (tile, light)'s sphere walk starts)
over its ``shadow.slots`` (128 for each (tile, light) whose sphere walk
runs).  Lower: the walks skip more.  None where the program samples no
``shadow.slots`` (a scene whose shadow kernel walks no sphere cluster, or
a program without the counters)."""

from benchmark import port_spans


def read(trace):
    return port_spans.sample_ratio(trace, "shadow.live", "shadow.slots")
