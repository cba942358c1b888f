"""The nuScenes and Waymo datasets through cli/train.py and cli/test.py on
the CPU, on small seeded full-density trees: a narrow Waymo PV-RCNN (the
shipped Waymo file with the model of tests/test_torch_waymo_pv_rcnn.py,
4096 points, a 128 x 128 x 40 grid), 2 steps at B = 2, then cli/test.py on
its checkpoint with ``EVAL_METRIC`` set to ``waymo`` by ``--set``; and the
tiny multi-head PointPillars on the shipped CBGS file (2048 points, gt of
width 10), 4 steps (4 frames resampled to 8) with its velocity targets and
cli/test.py with the
SDK-free nuScenes evaluation."""
from __future__ import annotations

import copy

import numpy as np
import yaml

from modest_tpu_torch import configs
from modest_tpu_torch.tools import synth_infos
from modest_tpu_torch.utils.config import Config
from tests.test_nuscenes_waymo import TINY_MULTIHEAD
from tests.test_torch_waymo_pv_rcnn import VOXEL_SIZE, waymo_pv_rcnn_cfg


def _run(tmp_path, full, steps, extra_test_args=()):
    from modest_tpu_torch.cli import test as test_cli
    from modest_tpu_torch.cli import train as train_cli

    cfg_file = tmp_path / "tiny.yaml"
    cfg_file.write_text(yaml.safe_dump(full.to_dict()))
    out = tmp_path / "out"
    state = train_cli.main(["--cfg_file", str(cfg_file), "--batch_size", "2", "--epochs", "1",
                            "--fix_random_seed", "--device", "cpu", "--output_dir", str(out)])
    assert [r["step"] for r in state.history] == list(range(steps))
    for rec in state.history:
        assert all(np.isfinite(v) for v in rec["metrics"].values()), rec["metrics"]
    return state, test_cli.main(["--cfg_file", str(cfg_file), "--ckpt_dir", str(out / "ckpt"),
                                 "--batch_size", "2", "--workers", "0", "--device", "cpu",
                                 "--output_dir", str(tmp_path / "eval"), *extra_test_args])


def test_waymo_pv_rcnn_train_and_test_clis(tmp_path):
    synth_infos.write_waymo_tree(tmp_path, 4, rng=np.random.RandomState(0), full_density=True,
                                 n_val=2, points=6000)
    np.random.seed(0)
    synth_infos.waymo_gt_database(tmp_path, configs.WAYMO_DATASET_BASE,
                                  configs.WAYMO_CLASS_NAMES)
    full = Config(copy.deepcopy(configs.WAYMO_CONFIGS["pv_rcnn"]))
    data = full.DATA_CONFIG
    data.DATA_PATH = str(tmp_path)
    data.SAMPLED_INTERVAL = {"train": 1, "test": 1}
    data.DATA_PROCESSOR[1].NUM_POINTS = {"train": 4096, "test": 4096}
    data.DATA_PROCESSOR[3].VOXEL_SIZE = VOXEL_SIZE
    full.MODEL = waymo_pv_rcnn_cfg()
    full.OPTIMIZATION.LR = 0.002
    _, (det_annos, results) = _run(tmp_path, full, 2,
                                   ["--set", "DATA_CONFIG.EVAL_METRIC", "waymo"])
    assert len(det_annos) == 2 and all(a["boxes_lidar"].shape[-1] == 7 for a in det_annos)
    assert "OBJECT_TYPE_TYPE_VEHICLE_LEVEL_2/APH" in results and "roi_0.3" in results["recall"]


def test_cbgs_pillars_train_and_test_clis(tmp_path):
    root = tmp_path / "v1.0-trainval"
    synth_infos.write_nuscenes_tree(root, 4, rng=np.random.RandomState(1), full_density=True,
                                    n_val=2, points=2500)
    np.random.seed(0)
    synth_infos.nuscenes_gt_database(root, configs.NUSCENES_DATASET_BASE,
                                     configs.CBGS_CLASS_NAMES,
                                     "nuscenes_infos_train_10sweeps_withvelo.pkl")
    full = Config(copy.deepcopy(configs.CBGS_CONFIGS["cbgs_pp_multihead"]))
    full.CLASS_NAMES = ["car", "pedestrian"]
    data = full.DATA_CONFIG
    data.DATA_PATH = str(tmp_path)
    data.DATA_PROCESSOR[2].NUM_POINTS = {"train": 2048, "test": 2048}
    data.VOXEL_SIZE = [1.6, 1.6, 8.0]
    full.MODEL = copy.deepcopy(TINY_MULTIHEAD)
    state, (det_annos, results) = _run(tmp_path, full, 4)  # CBGS resampling: 8 frames
    assert {"rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir"} <= set(state.history[0]["metrics"])
    assert len(det_annos) == 2 and all(a["boxes_lidar"].shape[-1] == 9 for a in det_annos)
    assert {"mAP", "NDS"} <= set(results)
