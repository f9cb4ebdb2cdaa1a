"""Percent of the traced stretch of frames in which the device ran no
operation: 1 - (union of device-busy intervals / the stretch's wall)."""

from benchmark.harness import idle_share


def read(trace):
    return idle_share(trace) if trace.units("frame") else None
