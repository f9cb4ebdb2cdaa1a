"""Seconds of set-up in the port's programs, self time: their
construction (``program.make``), each step's first, eager run
(``program.first``) and its capture (``program.capture``)."""

from benchmark import port_spans


def read(trace):
    return port_spans.setup_s("programs")
