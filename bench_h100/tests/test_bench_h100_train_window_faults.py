"""A fault that starts only after set-up's checked steps (two of them in the
tiny mix) passes every check of those steps, and the window's drawn step
makes the run not correct (faults.py)."""
from __future__ import annotations

import pytest

import faults


@pytest.mark.parametrize("fault", [faults.skipped_update_after_warmup,
                                   faults.cached_step_after_warmup], ids=lambda f: f.__name__)
def test_a_fault_after_the_checked_steps_is_caught_in_the_window(bench_tree, monkeypatch, fault):
    fault(monkeypatch)
    result = faults.tiny_train_run(bench_tree)
    checks = result["checks"]
    assert result["correct"] is False, checks
    for name in ("first_loss_gap", "moment_gap", "first_change_gap"):
        assert checks[name]["value"] <= checks[name]["limit"], (name, checks)
    assert checks["step_change_gap"]["value"] == 1.0, checks
