"""tools/train_probe.py on the CPU at the tiny config (512 points): the
ball-query tape counts and substitutes indices, the gradient-gap probe of
the CPU against itself finds no difference and a float64 run within float32
rounding, the divergence probe records each step and names the module
where a non-finite value starts, and the detection-gap probe of the CPU
against itself agrees at every stage. Also chip_smoke.py's stage-by-stage
detection check (forward_chain, check_chain, and the grid detectors'
grid_forward_chain, check_grid_chain): it names the stage a changed weight
parts, and it lets the end-to-end match fall short only where a device's own
decision kept another box. And the batch-norm probe (bn_gap) of the CPU
against itself."""
import copy
import json
import types

import numpy as np
import pytest
import torch

from modest_tpu_torch.configs import (POINTRCNN_DYNAMIC_OBJ_DATA_CONFIG,
                                      POINTRCNN_DYNAMIC_OBJ_FULL,
                                      POINTRCNN_DYNAMIC_OBJ_OPTIMIZATION)
from modest_tpu_torch.data.kitti_dataset import create_kitti_infos
from modest_tpu_torch.data.loader import build_dataloader
from modest_tpu_torch.models import api, build_network
from modest_tpu_torch.ops import pointnet2 as p2
from modest_tpu_torch.tools import train_probe
from modest_tpu_torch.utils.config import Config

import synth_kitti
from test_pointrcnn_model import tiny_model_cfg
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def cfg_and_batch(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_probe")
    synth_kitti.make_dataset(root, n_train=4, n_val=0, seed=3)
    dcfg = copy.deepcopy(POINTRCNN_DYNAMIC_OBJ_DATA_CONFIG)
    dcfg["DATA_PATH"] = str(root)
    dcfg["DATA_PROCESSOR"][1]["NUM_POINTS"] = {"train": 512, "test": 512}
    create_kitti_infos(Config(dcfg), ["Dynamic"], root, root, if_val=False)
    _, loader = build_dataloader(Config(dcfg), ["Dynamic"], 2, training=True)
    b = next(iter(loader))
    cfg = Config({"MODEL": tiny_model_cfg(), "OPTIMIZATION": POINTRCNN_DYNAMIC_OBJ_OPTIMIZATION})
    return cfg, {"points": torch.from_numpy(b["points"]),
                 "gt_boxes": torch.from_numpy(b["gt_boxes"])}


def test_ball_query_tape_counts_and_substitutes():
    rng = np.random.RandomState(0)
    d2 = torch.from_numpy(rng.uniform(0, 2, (1, 6, 40)).astype(np.float32))
    with train_probe.BallQueryTape() as ref:
        want = p2.ball_query_from_dist2(d2, 1.0, 4)
    assert p2.ball_query_from_dist2 is not ref  # the module's function is back
    moved = [(want[0].roll(1, dims=1), want[1])]  # centers 0..5 take the next center's row
    differ = int((want[0].roll(1, dims=1) != want[0]).sum())
    with train_probe.BallQueryTape(moved, substitute=False) as tape:
        own = p2.ball_query_from_dist2(d2, 1.0, 4)
    assert torch.equal(own[0], want[0]) and tape.differ[0]["slots_differ"] == differ > 0
    with train_probe.BallQueryTape(moved, substitute=True) as tape:
        got = p2.ball_query_from_dist2(d2, 1.0, 4)
    assert torch.equal(got[0], moved[0][0]) and tape.differ[0]["slots_differ"] == differ


def test_grad_gap_of_the_cpu_against_itself(cfg_and_batch):
    """With the CPU in the card's place every ball query, max-pool, loss and
    gradient agrees; the float64 run replays the float32 run's choices and
    its gradients part from float32's by rounding only."""
    cfg, batch = cfg_and_batch
    r = train_probe.grad_gap(torch.device("cpu"), cfg, batch)
    assert len(r["card"]["ball_queries"]) == 5 and len(r["card"]["max_pools"]) == 5
    assert all(q["slots_differ"] == 0 for q in r["card"]["ball_queries"])
    assert all(p["maxima_from_other_point"] == 0 for p in r["card"]["max_pools"])
    assert all(g["max"] == 0 for g in r["grad_rel_err"]["card_vs_cpu"].values())
    assert r["card_metrics"] == r["cpu_metrics"] and r["sampled_roi_match"] == 1.0
    # the float64 run: the backbone's 4 ball queries and max-pools, the same positives
    assert len(r["float64"]["max_pools"]) == 4
    assert all(p["maxima_from_other_point"] == 0 for p in r["float64"]["max_pools"])
    assert r["float64_metrics"]["point_pos_num"] == r["cpu_metrics"]["point_pos_num"]
    f64 = r["grad_rel_err"]["cpu_vs_float64"]["backbone_point_head"]
    assert f64["n"] == r["grad_rel_err"]["card_vs_cpu"]["backbone_point_head"]["n"] > 40
    assert 0 < f64["max"] < 1e-3, f64
    assert "roi_head" not in r["grad_rel_err"]["cpu_vs_float64"]


def test_locate_names_the_first_nonfinite_module(cfg_and_batch):
    cfg, batch = cfg_and_batch
    model = train_probe.build_network(cfg.MODEL, 1, device="cpu", seed=1).train()
    with torch.no_grad():
        model.point_head.cls_layers[0].weight[0, 0] = float("nan")
    draws = train_probe.step_roi_draws(cfg.MODEL, 2, 0, 666, "cpu")
    found = train_probe.locate(model, cfg.MODEL, batch, draws)
    assert found["first_nonfinite_module"]["module"] == "point_head.cls_layers.0"
    assert found["first_nonfinite_module"]["inputs_nonfinite"] == []
    assert "point_cls_preds" in found["out_nonfinite"]
    assert not np.isfinite(found["metrics"]["point_loss_cls"])
    assert "returned nan values" in found["backward_anomaly"]


def test_diverge_records_every_step(cfg_and_batch, capsys):
    cfg, batch = cfg_and_batch
    train_probe.diverge(torch.device("cpu"), cfg, batch, steps=3)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r["step"] for r in lines] == [0, 1, 2]
    assert all(r["finite"] and r["probe"] == "diverge" for r in lines)
    assert lines[1]["lr"] == pytest.approx(0.01, rel=1e-6)  # the one-cycle peak of 3 steps


def test_det_gap_of_the_cpu_against_itself(tmp_path, capsys):
    synth_kitti.make_dataset(tmp_path, n_train=4, n_val=0, seed=3)
    cfg = Config(copy.deepcopy(POINTRCNN_DYNAMIC_OBJ_FULL))
    cfg.DATA_CONFIG.DATA_PATH = str(tmp_path)
    cfg.DATA_CONFIG.DATA_PROCESSOR[1].NUM_POINTS = {"train": 512, "test": 512}
    create_kitti_infos(cfg.DATA_CONFIG, ["Dynamic"], tmp_path, tmp_path, if_val=False)
    cfg.MODEL = tiny_model_cfg()
    rows = train_probe.det_gap(torch.device("cpu"), cfg, trials=1, lr=1e-3)
    (row,) = rows
    assert row["verdict"] == "pass" and row["final"]["match_frac"] == 1.0
    assert row["final"]["card_detections"] > 0
    assert row["chain"] == {"point_tol_used": 0.0, "proposals_given_card_points": 1.0,
                            "rcnn_tol_used": 0.0, "finals_given_card_rcnn": 1.0,
                            "proposals_card_vs_cpu": 1.0, "finals_given_card_rois": 1.0}
    for nms in ("proposal_nms_cpu", "final_nms_cpu"):  # the gaps are 0: no pair is a tie
        assert row[nms]["keeps"] > 0 and row[nms]["ambiguous_pairs"] == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["probe"] == "det_gap"


@pytest.mark.parametrize("stats", ["calibrated", "randomised"])
def test_bn_gap_of_the_cpu_against_itself(cfg_and_batch, stats):
    """With the CPU in the card's place every layer agrees bit for bit, the
    float64 run parts from float32 by rounding only, and every batch norm's
    conditioning is reported."""
    cfg, batch = cfg_and_batch
    r = train_probe.bn_gap(torch.device("cpu"), cfg.MODEL, 1, batch, stats)
    assert r["stats"] == stats and r["points"] == 512 and r["ball_queries_differ"] == 0
    assert r["point_tol_used"]["card_vs_cpu"] == 0.0 and r["heading_wraps"]["card_vs_cpu"] == 0
    names = [row["layer"] for row in r["layers"]]
    assert names[-3:] == ["point_cls_preds", "point_box_preds", "point_boxes_decoded"]
    assert "backbone_3d.SA_modules.0" in names and "backbone_3d.FP_modules.0" in names
    model = train_probe.build_network(cfg.MODEL, 1, device="cpu")
    bns = [n for part in ("backbone_3d", "point_head")
           for n, m in model.get_submodule(part).named_modules(prefix=part)
           if isinstance(m, torch.nn.BatchNorm1d)]
    assert sorted(row["layer"] for row in r["layers"] if "max_mean_over_std" in row) == sorted(bns)
    for row in r["layers"]:
        assert row["card_vs_cpu"] == 0.0
        assert row["cpu_vs_float64"] <= 1e-4 * max(row["ref_absmax"], 1.0)
    with pytest.raises(ValueError, match="neither"):
        train_probe.bn_gap(torch.device("cpu"), cfg.MODEL, 1, batch, "identity")


def test_nms_ambiguity_finds_tied_overlapping_pairs():
    boxes = torch.tensor([[0, 0, 0, 2, 2, 1, 0], [0.1, 0, 0, 2, 2, 1, 0], [9, 0, 0, 2, 2, 1, 0]])
    scores = torch.tensor([0.5, 0.5 - 1e-7, 0.5 - 2e-7])
    tied = train_probe.nms_ambiguity(boxes, scores, 0.5, 10, 1e-6, 1e-3)
    # box 1 overlaps kept box 0 and ties with it; box 2 ties with box 0 but lies apart
    assert tied == {"keeps": 2, "keeps_before_ambiguity": 1, "ambiguous_pairs": 1}
    apart = train_probe.nms_ambiguity(boxes, scores, 0.5, 10, 1e-8, 1e-3)
    assert apart == {"keeps": 2, "keeps_before_ambiguity": 2, "ambiguous_pairs": 0}


@pytest.fixture(scope="module")
def chain_inputs():
    import chip_smoke

    model_cfg = Config(tiny_model_cfg())
    model_cfg.POST_PROCESSING.SCORE_THRESH = 0.0
    rng = np.random.RandomState(0)
    scan = np.concatenate([rng.uniform(-20, 20, (512, 3)), rng.uniform(0, 1, (512, 1))], 1)
    return chip_smoke, model_cfg, torch.from_numpy(scan.astype(np.float32))[None]


@pytest.mark.parametrize("part, stage", [(None, None),
                                         ("point_head.cls_layers.3.bias", "point_tol_used"),
                                         ("roi_head.reg_layers.3.bias", "rcnn_tol_used")])
def test_forward_chain_names_the_stage_a_changed_weight_parts(chain_inputs, part, stage):
    cs, model_cfg, scan = chain_inputs
    want = train_probe.build_network(model_cfg, 1, device="cpu", seed=0)
    got = train_probe.build_network(model_cfg, 1, device="cpu", seed=0)
    if part is not None:
        with torch.no_grad():
            dict(got.named_parameters())[part].add_(0.01)  # 20x and 5x the matcher's limits
    chain, fin_got, fin_want = cs.forward_chain(torch, np, got, want, model_cfg, scan)
    match = cs.match_finals(np, fin_got, fin_want)
    detections = match["card_detections"] + match["cpu_detections"]
    assert detections > 0
    if stage is None:
        assert chain["point_tol_used"] == chain["rcnn_tol_used"] == 0.0
        cs.check_chain(chain, match["match_frac"], detections, "unchanged")
        return
    assert chain[stage] > 1.0
    with pytest.raises(SystemExit):
        cs.check_chain(chain, match["match_frac"], detections, part)


@pytest.mark.parametrize("proposals, finals, passes", [(1.0, 1.0, False), (0.99, 1.0, True),
                                                       (1.0, 0.5, True)])
def test_check_chain_excuses_a_short_match_only_where_a_decision_parted(
        chain_inputs, proposals, finals, passes):
    cs = chain_inputs[0]
    chain = {"point_tol_used": 0.01, "proposals_given_card_points": 1.0, "rcnn_tol_used": 0.01,
             "finals_given_card_rcnn": 1.0, "proposals_card_vs_cpu": proposals,
             "finals_given_card_rois": finals}
    if passes:
        cs.check_chain(chain, 0.5, 20, "parted")
    else:
        with pytest.raises(SystemExit):
            cs.check_chain(chain, 0.5, 20, "not parted")
    cs.check_chain(dict(chain, proposals_card_vs_cpu=1.0, finals_given_card_rois=1.0), 0.98, 20,
                   "matched")
    with pytest.raises(SystemExit):
        cs.check_chain(dict(chain, finals_given_card_rcnn=0.9), 1.0, 20, "final NMS")


@pytest.fixture(scope="module")
def grid_chain_inputs():
    """``TINY_MULTIHEAD`` (two groups, multi-class NMS) and one 5-feature
    scan."""
    import chip_smoke
    from test_nuscenes_waymo import TINY_MULTIHEAD

    ds = types.SimpleNamespace(point_cloud_range=(-16.0, -16.0, -5.0, 16.0, 16.0, 3.0),
                               voxel_size=(1.0, 1.0, 8.0), grid_size=(32, 32, 1),
                               class_names=["car", "pedestrian"], num_point_features=5)
    rng = np.random.RandomState(0)
    scan = torch.from_numpy(rng.uniform(-15, 15, (1, 256, 5)).astype(np.float32))
    return chip_smoke, Config(copy.deepcopy(TINY_MULTIHEAD)), ds, scan


@pytest.mark.parametrize("shift", [0.0, 0.01])
def test_grid_forward_chain_names_a_changed_dense_output(grid_chain_inputs, shift):
    """The same weights agree at every stage; a class bias moved by 20x the
    matcher's score limit parts at the dense stage."""
    cs, cfg, ds, scan = grid_chain_inputs
    want = build_network(cfg, 2, device="cpu", seed=0, dataset=ds)
    got = build_network(cfg, 2, device="cpu", seed=0, dataset=ds)
    with torch.no_grad():
        for name, p in got.named_parameters():
            if "conv_cls" in name and name.endswith("bias"):
                p.add_(shift)
    chain, fin_got, fin_want = cs.grid_forward_chain(torch, np, api, got, want, cfg, scan)
    match = cs.match_finals(np, fin_got, fin_want)
    detections = match["card_detections"] + match["cpu_detections"]
    assert match["card_detections"] > 0
    if not shift:
        assert chain == {"dense_tol_used": 0.0, "finals_given_card_dense": 1.0,
                         "cpu_finals_own_dense": 1.0}
        assert match["match_frac"] == 1.0
        cs.check_grid_chain(chain, match["match_frac"], detections, "unchanged")
        return
    assert chain["dense_tol_used"] > 1.0 and chain["finals_given_card_dense"] == 1.0
    with pytest.raises(SystemExit):
        cs.check_grid_chain(chain, match["match_frac"], detections, "shifted")


@pytest.mark.parametrize("own, passes", [(1.0, False), (0.95, True)])
def test_check_grid_chain_excuses_a_short_match_only_where_the_cpus_own_nms_parted(
        grid_chain_inputs, own, passes):
    cs = grid_chain_inputs[0]
    chain = {"dense_tol_used": 0.1, "finals_given_card_dense": 1.0, "cpu_finals_own_dense": own}
    if passes:
        cs.check_grid_chain(chain, 0.9, 20, "parted")
    else:
        with pytest.raises(SystemExit):
            cs.check_grid_chain(chain, 0.9, 20, "not parted")
    cs.check_grid_chain(dict(chain, cpu_finals_own_dense=1.0), 0.98, 20, "matched")
    for bad in ({"finals_given_card_dense": 0.9}, {"dense_tol_used": 1.5}):
        with pytest.raises(SystemExit):
            cs.check_grid_chain(dict(chain, **bad), 1.0, 20, f"{bad}")
    with pytest.raises(SystemExit):
        cs.check_grid_chain(chain, 1.0, 0, "no detection")
