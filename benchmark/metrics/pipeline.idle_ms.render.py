"""Device-idle ms a frame while the innermost port span open is a
``pipeline.*`` one (the camera upload, a band outside its steps, the
assembly, the copy to the host).  Idle outside every port span is the
caller's: the rest of ``device.idle_share.render``."""

from benchmark import port_spans


def read(trace):
    return port_spans.idle_ms(trace, "pipeline")
