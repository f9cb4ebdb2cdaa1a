"""Device-idle ms a frame while the host is inside a ``program.*`` span
of the port (a step's launch, a flag read), the innermost port span
open; from the port's spans and the stretch's device intervals."""

from benchmark import port_spans


def read(trace):
    return port_spans.idle_ms(trace, "program")
