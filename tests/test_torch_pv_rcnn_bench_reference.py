"""The port's PV-RCNN against the benchmark's plain reference
(``bench_h100/reference/pv_rcnn.py``) on the CPU, stage by stage as the
``pv_rcnn_dynamic_obj`` cell's ``compare_batch`` compares them: seeded
random weights, the configuration's widths, one synthetic scan of 8192
points, 512 keypoints and 32 RoIs (fewer than the cell's 2048 and 100, to
keep the CPU's share small).

Stage 1, the keypoints, the RoIs and the final boxes are the same
arithmetic on both sides, so they must agree exactly. The VSA features may
part by ``VSA_TOL``: the port computes each source's (B, M, N) distances in
one matrix product where the reference takes the centres in blocks, and a
matrix product may round by the shape it is given. A planted change to one
VSA radius in the port parts the features by far more.
"""
from __future__ import annotations

import copy
import json
from pathlib import Path

import pytest
import torch

from bench_h100.harness import compare, manifest
from bench_h100.traffic.weights import seeded_weights
from modest_tpu_torch.models import api
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CONFIG = "pv_rcnn_dynamic_obj"
POINTS, KEYPOINTS, ROIS = 8192, 512, 32
SEED = 2 ** 31 + 22
VSA_TOL = 1e-5  # float32 features of order 1 after sums of a few hundred products
EXACT = ("dense_logit_gap", "keypoint_miss", "roi_miss", "final_miss")


def small_config() -> dict:
    cfg = manifest.load_json(manifest.BENCH_DIR / "configs" / f"{CONFIG}.json")
    for proc in cfg["DATA_CONFIG"]["DATA_PROCESSOR"]:
        if proc["NAME"] == "sample_points":
            proc["NUM_POINTS"] = {"train": POINTS, "test": POINTS}
    cfg["MODEL"]["PFE"]["NUM_KEYPOINTS"] = KEYPOINTS
    cfg["MODEL"]["ROI_HEAD"]["NMS_CONFIG"]["TEST"]["NMS_POST_MAXSIZE"] = ROIS
    return cfg


@pytest.fixture(scope="module")
def cell():
    """(recipe, config, port, one scan (1, N, 4), the reference's outputs
    and finals)."""
    recipe = manifest.load_module(manifest.BENCH_DIR / "configs" / f"{CONFIG}.py",
                                  "test_pv_rcnn_recipe")
    cfg = small_config()
    generator = manifest.load_generator("traffic/lyft_scans.py")
    points, _ = generator.make_batches(SEED, {"batch": 1, "pool": 1}, cfg, POINTS)
    points = torch.from_numpy(points[0])
    reference = recipe.build_reference(cfg, "cpu")
    seeded_weights(reference, SEED)
    port = recipe.build_port(cfg, "cpu")
    port.load_state_dict(reference.state_dict(), strict=True)
    return recipe, cfg, port, points, recipe.reference_eval(reference, cfg, points)


def port_numbers(cell) -> dict:
    recipe, _, port, points, (want_out, want_final) = cell
    out = api.apply_eval(port, port.model_cfg, points)
    final = api.post_process(out, port.model_cfg)
    tally = compare.Tally()
    recipe.compare_batch(tally, out, final, want_out, want_final)
    return tally.numbers(), int(final["valid"].sum())


def test_the_port_agrees_with_the_reference_stage_by_stage(cell):
    numbers, finals = port_numbers(cell)
    assert finals > 0
    assert {k: numbers[k] for k in EXACT} == dict.fromkeys(EXACT, 0.0), numbers
    assert numbers["vsa_feature_gap"] <= VSA_TOL, numbers


def test_a_planted_vsa_radius_fails_the_comparison(cell, monkeypatch):
    port = cell[2]
    source = port.vsa["raw_points"]
    monkeypatch.setattr(source, "radii", (source.radii[0] * 1.1, *source.radii[1:]))
    numbers, _ = port_numbers(cell)
    assert numbers["vsa_feature_gap"] > 100 * VSA_TOL, numbers


def test_the_configuration_is_the_shipped_yaml_with_the_ports_voxel_cap():
    from modest_tpu_torch.models.grid_detectors import MAX_VOXELS
    from modest_tpu_torch.utils.config import cfg_from_yaml_file

    cfg = manifest.load_json(manifest.BENCH_DIR / "configs" / f"{CONFIG}.json")
    root = Path(__file__).resolve().parents[1]
    shipped = cfg_from_yaml_file(str(root / cfg["shipped"])).to_dict()
    run = {k: v for k, v in cfg.items() if k in shipped}
    detail = cfg["reduced_detail"][
        "DATA_CONFIG.DATA_PROCESSOR.transform_points_to_voxels.MAX_NUMBER_OF_VOXELS.test"]
    assert detail["run"] == MAX_VOXELS
    cut = copy.deepcopy(shipped)
    for proc in cut["DATA_CONFIG"]["DATA_PROCESSOR"]:
        if proc["NAME"] == "transform_points_to_voxels":
            assert proc["MAX_NUMBER_OF_VOXELS"]["test"] == detail["source"]
            proc["MAX_NUMBER_OF_VOXELS"]["test"] = detail["run"]
    assert json.loads(json.dumps(run)) == json.loads(json.dumps(cut))
