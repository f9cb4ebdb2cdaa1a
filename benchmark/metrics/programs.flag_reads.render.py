"""The port's flag reads a frame (``program.flags`` spans): each is a
device sync between a program's steps."""

from benchmark import port_spans


def read(trace):
    return port_spans.spans_per_frame(trace, "program.flags")
