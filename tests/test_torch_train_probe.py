"""tools/train_probe.py on the CPU at the tiny config (512 points): the
ball-query tape counts and substitutes indices, the gradient-gap probe of
the CPU against itself finds no difference and a float64 run within float32
rounding, and the divergence probe records each step and names the module
where a non-finite value starts."""
import copy
import json

import numpy as np
import pytest
import torch

from modest_tpu_torch.configs import (POINTRCNN_DYNAMIC_OBJ_DATA_CONFIG,
                                      POINTRCNN_DYNAMIC_OBJ_OPTIMIZATION)
from modest_tpu_torch.data.kitti_dataset import create_kitti_infos
from modest_tpu_torch.data.loader import build_dataloader
from modest_tpu_torch.ops import pointnet2 as p2
from modest_tpu_torch.tools import train_probe
from modest_tpu_torch.utils.config import Config

import synth_kitti
from test_pointrcnn_model import tiny_model_cfg


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
