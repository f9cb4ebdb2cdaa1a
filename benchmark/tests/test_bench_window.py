"""The window arithmetic on made-up timelines: the idle share and
per-unit device times from intervals, host ops, idle gaps."""

from __future__ import annotations

import pytest
import torch  # noqa: F401 (loaded, as in a run, before any span)

from benchmark import harness


def _trace(device, host=(), spans=(), counters=None):
    return harness.Trace(list(device), list(host), list(spans),
                         ["closest_kernel", "shadow_kernel"], counters or {})


def test_union_and_idle_share_from_intervals():
    assert harness.union_ns([(0, 10), (5, 20), (30, 40)]) == 30
    t = _trace([("void closest_kernel<true>(int)", 0, 30),
                ("sort", 20, 50), ("copy", 70, 80), ("late", 90, 200)],
               spans=[("bench.frame", 0, 50), ("bench.frame", 50, 100)])
    assert t.window == (0, 100) and t.window_s == 100 / 1e9
    assert t.busy_ns() == 50 + 10 + 10           # clipped to the window
    assert harness.idle_share(t) == pytest.approx(30.0)
    # per frame: the port kernel 30 ns, the rest (clipped) 30 + 10 + 10
    assert harness.device_ms_per(t, "frame", port=True) == pytest.approx(15e-6)
    assert harness.device_ms_per(t, "frame", port=False) == pytest.approx(25e-6)
    assert harness.device_ms_per(t, "step", port=True) is None


def test_idle_share_reads_nothing_without_device_work():
    t = _trace([], spans=[("bench.frame", 0, 50)])
    assert harness.idle_share(t) is None


def test_top_level_host_ops_and_named_gaps():
    host = [("aten::copy_", 0, 10, 1), ("aten::empty", 2, 3, 1),
            ("cudaGraphLaunch", 12, 14, 1), ("aten::add", 20, 40, 1),
            ("aten::mul", 25, 30, 1), ("aten::sum", 5, 6, 2)]
    t = _trace([("k", 0, 12), ("k", 45, 100)], host,
               [("bench.step", 0, 50), ("bench.step", 50, 100)])
    assert t.top_level_host_ops() == 3           # copy_, add; sum on thread 2
    gaps = harness.idle_gaps(t)
    assert gaps[0] == ("aten::mul", pytest.approx(33e-9))
    assert [g[0] for g in harness.device_ops(t)] == ["k"]

