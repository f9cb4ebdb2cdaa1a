"""Percent of the traced stretch of training steps in which the device ran
no operation."""

from benchmark.harness import idle_share


def read(trace):
    return idle_share(trace) if trace.units("step") else None
