"""A PV-RCNN eval run whose timed path is broken underneath comes out not
correct, and the same run without a fault comes out correct (faults.py).
The tiny cell's configuration takes 8192 points a scan, 512 keypoints and 32
RoIs, to keep the CPU's share small."""
from __future__ import annotations

import json

import pytest

import faults
from bench_h100 import run as bench_run
from conftest import add_tiny_cell

CONFIG = "pv_rcnn_dynamic_obj"
SEED = 2 ** 31 + 23


def tiny_run(bench_tree, pool=1):
    tree, manifest_path, bench = bench_tree
    name = add_tiny_cell(tree, bench, manifest_path, CONFIG, batch=2, pool=pool, compare=pool,
                         points=8192)
    path = tree / "configs" / f"{name}_cfg.json"
    cfg = json.loads(path.read_text())
    cfg["MODEL"]["PFE"]["NUM_KEYPOINTS"] = 512
    cfg["MODEL"]["ROI_HEAD"]["NMS_CONFIG"]["TEST"]["NMS_POST_MAXSIZE"] = 32
    path.write_text(json.dumps(cfg))
    return bench_run.run(["--workload", name, "--seed", str(SEED), "--seconds", "0"],
                         device="cpu", benchmark=manifest_path, bench_dir=tree)


@pytest.mark.parametrize("fault", [faults.stale_answer, faults.eval_half_batch,
                                   faults.eval_altered_answer], ids=lambda f: f.__name__)
def test_a_planted_fault_makes_the_run_not_correct(bench_tree, monkeypatch, fault):
    fault(monkeypatch)
    # a stale answer shows only once a second batch follows the first
    result = tiny_run(bench_tree, pool=2 if fault is faults.stale_answer else 1)
    assert result["correct"] is False, result["checks"]


def test_the_same_run_without_a_fault_is_correct(bench_tree):
    result = tiny_run(bench_tree)
    assert result["correct"] is True, result["checks"]
    assert set(result["checks"]) == {"dense_logit_gap", "keypoint_miss", "vsa_feature_gap",
                                     "roi_miss", "final_miss", "failed_batches"}
