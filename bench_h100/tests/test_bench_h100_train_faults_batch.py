"""A PointRCNN train run that leaves half of each batch out, or alters the
loss it reports, comes out not correct (faults.py)."""
from __future__ import annotations

import pytest

import faults


@pytest.mark.parametrize("fault", [faults.train_half_batch, faults.train_altered_answer],
                         ids=lambda f: f.__name__)
def test_a_planted_fault_makes_the_train_run_not_correct(bench_tree, monkeypatch, fault):
    fault(monkeypatch)
    result = faults.tiny_train_run(bench_tree)
    assert result["correct"] is False, result["checks"]
