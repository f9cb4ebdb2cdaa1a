"""Percent of the frames' bounce work past the first reflection: the
stretch's ``wave.deep`` samples (rays active entering bounce 2 or later)
over its ``wave.active`` ones (rays active entering any bounce).  None
where the program samples no ``wave.deep`` at all (one without the
counter)."""

from benchmark import port_spans


def read(trace):
    rec = port_spans.record()
    if rec is None or not any(s.name == "wave.deep" for s in list(rec.samples)):
        return None
    return port_spans.sample_ratio(trace, "wave.deep", "wave.active")
