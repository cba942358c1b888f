"""A second eval run whose timed path is broken underneath comes out not
correct, and the same run without a fault comes out correct (faults.py)."""
from __future__ import annotations

import pytest

import faults

CONFIG = "second_dynamic_obj"
SEED = 2 ** 31 + 21


@pytest.mark.parametrize("fault", [faults.stale_answer, faults.eval_half_batch,
                                   faults.eval_altered_answer], ids=lambda f: f.__name__)
def test_a_planted_fault_makes_the_run_not_correct(bench_tree, monkeypatch, fault):
    fault(monkeypatch)
    # a stale answer shows only once a second batch follows the first
    pool = 2 if fault is faults.stale_answer else 1
    result = faults.tiny_eval_run(bench_tree, CONFIG, SEED, pool=pool)
    assert result["correct"] is False, result["checks"]


def test_the_same_run_without_a_fault_is_correct(bench_tree):
    result = faults.tiny_eval_run(bench_tree, CONFIG, SEED)
    assert result["correct"] is True, result["checks"]
    assert list(result)[-1] == "checks"
