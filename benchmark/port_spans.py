"""The port's own spans and counters (``raytracer_tpu_torch.tracing``) as
the per-layer readers of a traced stretch see them.

``record()`` is the recorder of the port loaded in this process: its
``spans`` (name, start, end, id, parent; ns on the profiler's clock, the
clock of ``harness.Trace``), ``samples`` (name, t, value) and ``totals``
(set-up span name -> self seconds).  A program without the recorder
gives None, and so does every reader.

Readers of a stretch of frames split each device-idle interval of the
stretch (``trace.device_in_window()``) among the innermost port spans
open during it, by the layer that names the span (``program.step`` ->
``program``); idle outside every port span is the caller's and counted
by no layer.  Set-up readers read ``totals``: in the drivers, set-up
spans (the kernel library's load, scene ingest, the accelerator build,
a program's construction, a step's first run and its capture) run in
set-up only.
"""

from __future__ import annotations

from typing import Optional

# the set-up spans of each set-up reader
SETUP = {"backend": ("backend.load",), "scene": ("scene.ingest",),
         "accel": ("accel.build",),
         "programs": ("program.make", "program.first", "program.capture")}


def record():
    """The port's recorder (``raytracer_tpu_torch.tracing``), or None."""
    try:
        from raytracer_tpu_torch import tracing
    except ImportError:
        return None
    return tracing


def _stretch(trace, kind: str = "frame"):
    """(recorder, frames) of a stretch of ``bench.<kind>`` spans with
    device work, or None."""
    rec = record()
    units = trace.units(kind)
    if rec is None or not units or not trace.device_in_window():
        return None
    return rec, units


def _in_window(trace, spans) -> list:
    a, b = trace.window
    return [s for s in spans if s.end > a and s.start < b]


def innermost(spans, a: int, b: int) -> list:
    """[(start, end, span or None)]: [a, b] cut where a span of ``spans``
    (nested, as one thread's are) starts or ends, each piece with the
    innermost span open through it."""
    spans = sorted((s for s in spans if s.end > a and s.start < b),
                   key=lambda s: (s.start, -s.end))
    pieces, stack, t = [], [], a

    def advance(x):
        nonlocal t
        while stack and stack[-1].end <= x:
            top = stack.pop()
            if top.end > t:
                pieces.append((t, top.end, top))
                t = top.end
        if x > t:
            pieces.append((t, x, stack[-1] if stack else None))
            t = x

    for s in spans:
        advance(max(s.start, a))
        stack.append(s)
    advance(b)
    return pieces


def idle_gaps(trace) -> list:
    """The stretch's device-idle intervals [(start, end)], in order."""
    a, b = trace.window
    gaps, cur = [], a
    for s, e in sorted((s, e) for _, s, e in trace.device_in_window()):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if b > cur:
        gaps.append((cur, b))
    return gaps


def idle_ns_by_layer(trace, spans) -> dict:
    """Device-idle ns of the stretch by the layer of the innermost port
    span open (``None``: outside every span)."""
    a, b = trace.window
    pieces = innermost(spans, a, b)
    out, i = {}, 0
    for gs, ge in idle_gaps(trace):
        while i < len(pieces) and pieces[i][1] <= gs:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < ge:
            ps, pe, span = pieces[j]
            ns = min(pe, ge) - max(ps, gs)
            if ns > 0:
                layer = span.name.split(".", 1)[0] if span else None
                out[layer] = out.get(layer, 0) + ns
            j += 1
    return out


def idle_ms(trace, layer: str) -> Optional[float]:
    """Device-idle ms a frame while the innermost port span is one of
    ``layer``'s; None without frames, device work or port spans."""
    got = _stretch(trace)
    if got is None:
        return None
    rec, frames = got
    spans = _in_window(trace, list(rec.spans))
    if not spans:
        return None
    return idle_ns_by_layer(trace, spans).get(layer, 0) / 1e6 / frames


def spans_per_frame(trace, name: str) -> Optional[float]:
    """Port spans ``name`` that start in the stretch, a frame."""
    got = _stretch(trace)
    if got is None:
        return None
    rec, frames = got
    a, b = trace.window
    spans = _in_window(trace, list(rec.spans))
    if not spans:
        return None
    return sum(1 for s in spans if s.name == name and a <= s.start) / frames


def sample_ratio(trace, num: str, den: str) -> Optional[float]:
    """Percent: the sum of the samples ``num`` in the stretch over that of
    ``den``'s; None where ``den`` sums to nothing."""
    got = _stretch(trace)
    if got is None:
        return None
    rec, _ = got
    a, b = trace.window
    sums = {num: 0, den: 0}
    for c in list(rec.samples):
        if c.name in sums and a <= c.t <= b:
            sums[c.name] += c.value
    if not sums[den]:
        return None
    return 100.0 * sums[num] / sums[den]


def setup_s(layer: str) -> Optional[float]:
    """The self seconds of ``layer``'s set-up spans (``SETUP``) in this
    process; None without the recorder."""
    rec = record()
    if rec is None:
        return None
    return sum(rec.totals.get(name, 0.0) for name in SETUP[layer])
