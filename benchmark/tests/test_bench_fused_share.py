"""``glue.fused_share.render`` on a made-up stretch and record: 100 where
every bounce's ``wave.active`` has its ``wave.fused``, the share where
some have none, and None without ``wave.fused`` samples (a program
without the epilogue kernels), frames, device work or the recorder."""

from __future__ import annotations

import types
from typing import NamedTuple

import pytest

from benchmark import harness, port_spans

NAME = "glue.fused_share.render"


class Sample(NamedTuple):
    name: str
    t: int
    value: float


def _trace(units=("bench.frame",) * 2, device=(("gather", 0, 50),)):
    """A stretch [0, 200] of two units, 100 ns each."""
    spans = [(u, 100 * i, 100 * (i + 1)) for i, u in enumerate(units)]
    return harness.Trace(list(device), [], spans, ["closest_kernel"], {})


def _record(monkeypatch, samples):
    rec = types.SimpleNamespace(spans=[], samples=list(samples), totals={})
    monkeypatch.setattr(port_spans, "record", lambda: rec)


BOUNCES = [(10, 4000), (60, 900), (150, 4000), (170, 300)]


@pytest.mark.parametrize("fused,want", [
    (BOUNCES, 100.0),
    (BOUNCES[:2], 100.0 * 4900 / 9200),
    ([], None),
])
def test_fused_share_of_the_stretch(bench, monkeypatch, fused, want):
    samples = [Sample("wave.active", t, v) for t, v in BOUNCES]
    samples += [Sample("wave.fused", t, v) for t, v in fused]
    samples.append(Sample("wave.fused", 250, 7))   # after the stretch
    if not fused:
        samples.pop()
    _record(monkeypatch, samples)
    got = bench.reader(NAME)(_trace())
    assert got == (None if want is None else pytest.approx(want))


def test_none_without_frames_device_work_or_recorder(bench, monkeypatch):
    _record(monkeypatch, [Sample("wave.active", 10, 5),
                          Sample("wave.fused", 10, 5)])
    read = bench.reader(NAME)
    assert read(_trace()) == 100.0
    assert read(_trace(units=("bench.step",) * 2)) is None
    assert read(_trace(device=())) is None
    monkeypatch.setattr(port_spans, "record", lambda: None)
    assert read(_trace()) is None
