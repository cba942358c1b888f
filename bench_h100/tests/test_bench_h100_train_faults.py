"""A PointRCNN train run whose optimizer leaves the state unchanged comes out
not correct, and the same run without a fault comes out correct (faults.py)."""
from __future__ import annotations

import faults


def test_an_unchanged_state_makes_the_train_run_not_correct(bench_tree, monkeypatch):
    faults.unchanged_state(monkeypatch)
    result = faults.tiny_train_run(bench_tree)
    assert result["correct"] is False, result["checks"]
    assert result["checks"]["first_change_gap"]["value"] == 1.0


def test_the_same_train_run_without_a_fault_is_correct(bench_tree):
    result = faults.tiny_train_run(bench_tree)
    assert result["correct"] is True, result["checks"]
    assert "train_scans_per_s" in result["metrics"]
