"""``correct`` fails where it must.  The control (the plain reference in
bfloat16, the precision below the configurations' float32, in the
program's place) fails each cell's limits; and whole CPU runs of each
cell, the look for a card skipped, come out not correct with the timed
path broken underneath: an answer altered where it is produced (every
cell), a training step that returns its state unchanged, one that
takes the mean over half of the batch, and one whose gradients go wrong
in size (not in sign) only after the checked steps of set-up.  No cell spans chips, so none can
leave out an exchange between them."""

from __future__ import annotations

import pytest
import torch

from conftest import run_small, small_config, small_traffic

from benchmark import calibrate, harness

CELLS = ["horse31k.frame-ssaa2", "marbles650.frame-ssaa2",
         "horse31k.train-1m"]


def _ctx(bench, workload):
    wl = bench.workload(workload)
    return harness.Context(bench, workload, 1, 1.0, False, 0.0, "cpu",
                           config=small_config(bench, wl["config"]),
                           traffic=small_traffic(bench, wl["traffic"]))


def _fails(readings: dict, limits: dict) -> bool:
    return any(not v <= limits[k] for k, v in readings.items())


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limits(bench, workload):
    ctx = _ctx(bench, workload)
    for seed in (3, 4, 5):
        if ctx.traffic["driver"] == "train":
            readings = calibrate.train_control(ctx, seed)
            assert _fails(readings["bf16"], ctx.limits)
            assert _fails(readings["half"], ctx.limits)
        else:
            assert _fails(calibrate._image_control(
                ctx, seed, calibrate.frame_shots(ctx)), ctx.limits)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_runs_are_correct(bench, tmp_path, workload):
    line = run_small(bench, workload, tmp_path)
    assert line["correct"], line
    assert line["attempted"] > 0 and line["failed"] == 0
    if workload == "horse31k.train-1m":
        assert {"end_loss_rel", "end_grad_rel",
                "end_change_rel"} <= set(line["checks"])


@pytest.mark.parametrize("workload", CELLS)
def test_an_altered_answer_is_not_correct(bench, tmp_path, monkeypatch,
                                          workload):
    from raytracer_tpu_torch.models import whitted
    from raytracer_tpu_torch.ops import shade

    orig = shade.shade_local

    def brighter(*a, **kw):
        return orig(*a, **kw) * 1.1

    monkeypatch.setattr(whitted, "shade_local", brighter)
    monkeypatch.setattr(shade, "shade_local", brighter)
    line = run_small(bench, workload, tmp_path)
    assert not line["correct"], line


def test_a_step_that_keeps_its_state_is_not_correct(bench, tmp_path,
                                                    monkeypatch):
    from raytracer_tpu_torch.parallel import train

    class Still(torch.optim.Adam):
        def step(self, closure=None):
            return None

    monkeypatch.setattr(train, "_adam", lambda params: Still(params))
    line = run_small(bench, "horse31k.train-1m", tmp_path)
    assert not line["correct"], line
    assert line["checks"]["change_rel"]["value"] > 0.9


def test_a_step_over_half_the_batch_is_not_correct(bench, tmp_path,
                                                   monkeypatch):
    from raytracer_tpu_torch.parallel import train

    orig = train.image_loss

    def half(params, data, meta, origin, dirs, target, *a, **kw):
        n = dirs.shape[0] // 2
        return orig(params, data, meta, origin, dirs[:n], target[:n], *a,
                    **kw)

    monkeypatch.setattr(train, "image_loss", half)
    line = run_small(bench, "horse31k.train-1m", tmp_path)
    assert not line["correct"], line


def test_gradients_wrong_in_size_late_are_not_correct(bench, tmp_path,
                                                      monkeypatch):
    """Twice the gradient from the step after set-up's on: Adam takes the
    size out of the update, so only the gradient read after the window
    sees it; set-up's checked steps pass."""
    from raytracer_tpu_torch.parallel import train

    after = (bench.traffic("train-1m")["checked_steps"]
             + small_traffic(bench, "train-1m")["warmup_steps"])

    class Late(torch.optim.Adam):
        calls = 0

        def step(self, closure=None):
            Late.calls += 1
            if Late.calls > after:
                for group in self.param_groups:
                    for p in group["params"]:
                        p.grad.mul_(2.0)
            return super().step(closure)

    monkeypatch.setattr(train, "_adam", lambda params: Late(params))
    line = run_small(bench, "horse31k.train-1m", tmp_path)
    assert not line["correct"], line
    checks = line["checks"]
    assert all(checks[k]["value"] <= checks[k]["limit"]
               for k in ("loss_rel", "grad_rel", "change_rel"))
    assert checks["end_grad_rel"]["value"] > checks["end_grad_rel"]["limit"]
