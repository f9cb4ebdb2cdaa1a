"""Percent of the frames' rays whose bounce epilogue ran as the port's two
epilogue kernels: the stretch's ``wave.fused`` samples (rays active
entering a bounce that went through ``cluster_trace.hit_record`` and
``cluster_trace.shade_bounce``) over its ``wave.active`` ones.  None where
the program samples no ``wave.fused`` at all (one without those
kernels)."""

from benchmark import port_spans


def read(trace):
    rec = port_spans.record()
    if rec is None or not any(s.name == "wave.fused" for s in list(rec.samples)):
        return None
    return port_spans.sample_ratio(trace, "wave.fused", "wave.active")
