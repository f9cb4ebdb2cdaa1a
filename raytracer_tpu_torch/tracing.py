"""The port's spans and counters, on the profiler's clock.

Spans name the layer they time (``pipeline.*``, ``program.*``,
``scene.ingest``, ``accel.build``, ``backend.load``) and record their
name, what they ran (``what``: a program step's name, a band's first
row), start, end, the span open when they began (``parent``) and their
thread.  Two kinds:

- ``span``: the hot path's (a frame, its upload, bands, assembly, copy to
  the host and ``write_image``; a program step's replay; a flag read).
  Recorded only while a ``torch.profiler`` records in this process
  (``torch.autograd.profiler._is_profiler_enabled``): otherwise a span
  costs that one check and records nothing.
- ``setup_span``: what runs once per scene or shape (the kernel library's
  load, scene ingest, the accelerator build, a program's construction, a
  step's first eager run and its capture).  Always recorded, and its self
  seconds (its time less its child spans') are added to ``totals``, by
  name; ``seconds`` reads them.

``sample(name, value)`` records a counter's value at an instant while a
profiler records: the wavefront's ``wave.active`` (rays active entering a
bounce), ``wave.lanes`` (128 x the live tiles its kernels see) and
``wave.deep`` (the active rays entering bounce 2 or later); on a scene
whose masks take the hierarchical route, ``mask.tiles`` (the active
tiles entering its mask calls), ``mask.chunks`` (the live (tile,
128-cluster chunk) pairs their supercluster pass hands
``ray_mask_hier``), ``lists.tiles`` (the (tile, list) shortlists with a
candidate that its compactions build) and ``lists.over`` (those past
their cap, which the visiting kernels walk as the bitmask); on a scene
whose shadow kernel walks sphere clusters, ``shadow.slots`` (128 for each
(tile, light) whose sphere walk runs) and ``shadow.live`` (the rays that
walk starts with: active toward the light and not occluded by a
triangle).

Stamps are ``time.time_ns()``: Unix-epoch ns, the clock kineto stamps
host events on, so spans and samples line up with a profiler's events.
They are not ``record_function`` events: a span around the pipeline's
ops would enclose them in the profiler's event tree.  ``spans`` and
``samples`` are bounded deques (the newest kept); ``merge_chrome_trace``
writes them into a profiler's exported trace.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

from torch.autograd import profiler as _profiler

MAX_SPANS = 1 << 16
MAX_SAMPLES = 1 << 16


class Span(NamedTuple):
    id: int
    parent: int          # the enclosing span's id; 0 for none
    name: str
    what: object         # a step's or program's name, a band's first row
    start: int           # ns, time.time_ns()
    end: int
    tid: int             # the thread's native id


class Sample(NamedTuple):
    name: str
    t: int               # ns, time.time_ns()
    value: float


spans: "collections.deque[Span]" = collections.deque(maxlen=MAX_SPANS)
samples: "collections.deque[Sample]" = collections.deque(maxlen=MAX_SAMPLES)
# set-up span name -> self seconds, over the life of the process
totals: dict = {}

_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()
_OFF = contextlib.nullcontext()


def recording() -> bool:
    """True while a ``torch.profiler`` records in this process."""
    return _profiler._is_profiler_enabled


def _thread():
    """This thread's open spans (``stack``) and native id (``tid``, read
    once: a system call, microseconds on some hosts)."""
    if not hasattr(_local, "stack"):
        _local.stack, _local.tid = [], threading.get_native_id()
    return _local


class _Open:
    """A span being timed; recorded when its block ends."""

    __slots__ = ("name", "what", "setup", "id", "parent", "start", "child_ns")

    def __init__(self, name: str, what, setup: bool):
        self.name, self.what, self.setup = name, what, setup

    def __enter__(self):
        stack = _thread().stack
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else 0
        self.child_ns = 0
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.time_ns()
        thread = _thread()
        stack = thread.stack
        stack.pop()
        ns = end - self.start
        if stack:
            stack[-1].child_ns += ns
        spans.append(Span(self.id, self.parent, self.name, self.what,
                          self.start, end, thread.tid))
        if self.setup:
            with _lock:
                totals[self.name] = (totals.get(self.name, 0.0)
                                     + (ns - self.child_ns) / 1e9)


def span(name: str, what=""):
    """``with span(name):`` a hot-path span, recorded while a profiler
    records (else nothing but the check)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Open(name, what, False)


def setup_span(name: str, what="") -> _Open:
    """``with setup_span(name):`` a set-up span: always recorded, its self
    seconds added to ``totals[name]``."""
    return _Open(name, what, True)


def sample(name: str, value) -> None:
    """Record ``value`` of the counter ``name`` now, while a profiler
    records."""
    if _profiler._is_profiler_enabled:
        samples.append(Sample(name, time.time_ns(), value))


def seconds(*names: str) -> float:
    """The self seconds of the set-up spans ``names`` so far."""
    with _lock:
        return sum(totals.get(n, 0.0) for n in names)


def clear() -> None:
    """Forget every recorded span, sample and total."""
    spans.clear()
    samples.clear()
    with _lock:
        totals.clear()


def merge_chrome_trace(path: str) -> int:
    """Add the recorded spans (``X`` events on their thread's row, the
    step in ``args``) and samples (``C`` counter events) that fall in the
    profiler's trace at ``path`` (``export_chrome_trace``'s file: ts in
    us from its ``baseTimeNanoseconds``) to it; returns the events
    added."""
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    events = trace.setdefault("traceEvents", [])
    stamps = [e["ts"] for e in events if e.get("ph") == "X" and "ts" in e]
    if not stamps:
        return 0
    first = base + min(stamps) * 1e3
    last = base + max(e["ts"] + e.get("dur", 0) for e in events
                      if e.get("ph") == "X" and "ts" in e) * 1e3
    pid = os.getpid()
    added = []
    for s in list(spans):
        if s.end >= first and s.start <= last:
            added.append({"ph": "X", "cat": "port", "pid": pid, "tid": s.tid,
                          "name": s.name, "ts": (s.start - base) / 1e3,
                          "dur": (s.end - s.start) / 1e3,
                          "args": {"what": str(s.what), "id": s.id,
                                   "parent": s.parent}})
    for c in list(samples):
        if first <= c.t <= last:
            added.append({"ph": "C", "cat": "port", "pid": pid,
                          "name": c.name, "ts": (c.t - base) / 1e3,
                          "args": {c.name.rsplit(".", 1)[-1]: c.value}})
    events.extend(added)
    with open(path, "w") as f:
        json.dump(trace, f)
    return len(added)
