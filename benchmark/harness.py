"""What every cell's run shares: its context, the import guard, the device
record, the traced stretch and its reduction to intervals, and the
result line.

A driver (``benchmark/drivers/<name>.py``) gets a ``Context``, builds the
program's set-up, calls ``ctx.setup_done()`` before its first timed call,
runs its window, records end-to-end values (``ctx.e2e``), the numbers
that decide ``correct`` (``ctx.check``) and, in a traced run, a
``Trace`` (``ctx.trace``) with the counters its per-layer metrics read.
"""

from __future__ import annotations

import dataclasses
import gc
import glob
import os
import re
import sys
import time
from typing import Optional

# top-level module names that no run of the port may load
FORBIDDEN = ("jax", "jaxlib", "flax", "raytracer_tpu")
SPAN = "bench."          # prefix of the harness's own record_function spans


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``raytracer_tpu_torch`` is not ``raytracer_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


class Context:
    """One run of one cell: its names, parameters and what it records."""

    def __init__(self, bench, workload: str, seed: int, seconds: float,
                 trace: bool, t_start: float, device="cuda",
                 config: Optional[dict] = None, traffic: Optional[dict] = None,
                 limits: Optional[dict] = None, work_dir: Optional[str] = None):
        self.bench, self.name = bench, workload
        self.wl = bench.workload(workload)
        self.config = config or bench.config(self.wl["config"])
        self.traffic = traffic or bench.traffic(self.wl["traffic"])
        self.limits = limits or bench.limits(workload)
        self.seed, self.seconds, self.trace_on = seed, seconds, trace
        self.t_start = t_start
        self.device = device
        tmp = os.environ.get("TMPDIR") or "/tmp"
        self.work_dir = work_dir or os.path.join(
            tmp, f"bench_{re.sub(r'[^A-Za-z0-9_.-]', '_', workload)}")
        os.makedirs(self.work_dir, exist_ok=True)
        self.setup_s = None
        self.e2e = {}
        self.checks = []
        self.attempted = self.failed = 0
        self.trace = None
        self.peak_bytes = 0

    def setup_done(self) -> None:
        """Set-up ends here: the program is loaded, built and warmed."""
        self.sync()
        self.setup_s = time.perf_counter() - self.t_start
        log(f"set-up: {self.setup_s:.3f} s")

    def leave_out(self, seconds: float) -> None:
        """Keep ``seconds`` of the benchmark's own work in set-up (the
        reference making an input) out of ``setup_s``."""
        self.t_start += seconds

    def sync(self) -> None:
        if self.device != "cpu":
            import torch

            torch.cuda.synchronize()

    def read_peak(self) -> None:
        """The process's peak of allocated device memory so far (read
        before any reference work on the card)."""
        if self.device != "cpu":
            import torch

            self.peak_bytes = torch.cuda.max_memory_allocated()

    def check(self, name: str, value: float, limit_key: Optional[str] = None
              ) -> None:
        self.checks.append(Check(name, float(value),
                                 float(self.limits[limit_key or name])))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)


def free_program() -> None:
    """Drop every captured program of the port and the caching
    allocator's free blocks (before the reference runs on the card)."""
    import torch

    from raytracer_tpu_torch.models import programs

    programs.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def port_kernel_names(root: str) -> list:
    """The ``__global__`` kernels of the port's CUDA sources."""
    names = []
    for path in sorted(glob.glob(os.path.join(
            root, "raytracer_tpu_torch", "csrc", "*.cu"))):
        with open(path) as f:
            names += re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)",
                f.read())
    return names


@dataclasses.dataclass
class Trace:
    """One profiled stretch of a window, as plain intervals (ns on the
    profiler's clock): device operations, host events, the harness's
    spans; ``counters``: what the driver counted beside it."""
    device: list          # (name, start, end)
    host: list            # (name, start, end, thread)
    spans: list           # (name, start, end)
    port_kernels: list    # kernel names of the port's csrc/*.cu
    counters: dict

    @property
    def window(self) -> tuple:
        return (min(s[1] for s in self.spans), max(s[2] for s in self.spans))

    @property
    def window_s(self) -> float:
        a, b = self.window
        return (b - a) / 1e9

    def units(self, kind: str) -> int:
        """Spans ``bench.<kind>`` in the stretch (frames, steps)."""
        return sum(1 for s in self.spans if s[0] == SPAN + kind)

    def is_port_kernel(self, name: str) -> bool:
        return any(re.search(r"\b" + k + r"\b", name)
                   for k in self.port_kernels)

    def device_in_window(self) -> list:
        a, b = self.window
        return [(n, max(s, a), min(e, b)) for n, s, e in self.device
                if e > a and s < b]

    def busy_ns(self) -> float:
        return union_ns([(s, e) for _, s, e in self.device_in_window()])

    def top_level_host_ops(self) -> int:
        """aten ops of the stretch nested in no other host event of their
        thread (the harness's spans do not count as enclosing)."""
        a, b = self.window
        ops = 0
        by_thread = {}
        for name, s, e, tid in self.host:
            if not name.startswith(SPAN) and s >= a and e <= b:
                by_thread.setdefault(tid, []).append((s, -e, name))
        for events in by_thread.values():
            events.sort()
            end = None
            for s, neg_e, name in events:
                if end is None or s >= end:
                    end = -neg_e
                    ops += name.startswith("aten::")
        return ops


def union_ns(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(trace: Trace, n: int = 10) -> list:
    """The ``n`` longest gaps between device-busy intervals of the
    stretch, longest first, each named by the innermost host event open
    at its middle: [(name, seconds)]."""
    a, b = trace.window
    gaps, cur = [], a
    for s, e in sorted((s, e) for _, s, e in trace.device_in_window()):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if b > cur:
        gaps.append((cur, b))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
    out = []
    for gs, ge in gaps:
        mid = (gs + ge) / 2
        inner = [(e - s, name) for name, s, e, _ in trace.host
                 if s <= mid <= e]
        out.append((min(inner)[1] if inner else "(no host event)",
                    (ge - gs) / 1e9))
    return out


def device_ops(trace: Trace) -> list:
    """Device operations of the stretch by total seconds, longest first."""
    by = {}
    for n, s, e in trace.device_in_window():
        by[n] = by.get(n, 0.0) + (e - s) / 1e9
    return sorted(by.items(), key=lambda kv: -kv[1])


def warm_profiler(device) -> None:
    """Start and stop the profiler once, in set-up: its first start
    (CUPTI's) takes seconds, which a traced stretch must not hold."""
    import torch

    with Profiled([]):
        torch.ones(1, device=device).add_(1)
    if device != "cpu":
        torch.cuda.synchronize()


class Profiled:
    """``with Profiled(kernels) as p: ...`` profiles the block (CPU and
    CUDA activities); ``p.trace(counters)`` reduces it to a ``Trace``."""

    def __init__(self, port_kernels: list):
        self.port_kernels = port_kernels

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)

    def trace(self, counters: dict) -> Trace:
        from torch.autograd import DeviceType

        device, host, spans = [], [], []
        for ev in self.prof.profiler.kineto_results.events():
            name = ev.name()
            s = ev.start_ns()
            e = s + ev.duration_ns()
            if ev.device_type() == DeviceType.CUDA:
                # the spans' annotations on the device timeline are no work
                if not name.startswith(SPAN):
                    device.append((name, s, e))
            elif name.startswith(SPAN):
                spans.append((name, s, e))
            else:
                host.append((name, s, e, ev.start_thread_id()))
        return Trace(device, host, spans, self.port_kernels, counters)


def span(kind: str):
    """A ``record_function`` span ``bench.<kind>`` around one unit of work."""
    from torch.profiler import record_function

    return record_function(SPAN + kind)


def device_record(ctx) -> dict:
    if ctx.device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": ctx.wl["chips"], "memory_peak_bytes": int(ctx.peak_bytes)}


def device_ms_per(trace: Trace, kind: str, port: bool) -> Optional[float]:
    """Device ms per ``bench.<kind>`` span of the stretch in the port's
    kernels (``port``) or in every other device operation; None when the
    stretch holds no such span or no device work."""
    units = trace.units(kind)
    events = trace.device_in_window()
    if not units or not events:
        return None
    ns = sum(e - s for n, s, e in events if trace.is_port_kernel(n) == port)
    return ns / 1e6 / units


def idle_share(trace: Trace) -> Optional[float]:
    """Percent of the stretch in which no device operation ran."""
    busy = trace.busy_ns()
    if not busy:
        return None
    a, b = trace.window
    return 100.0 * (1.0 - busy / (b - a))

