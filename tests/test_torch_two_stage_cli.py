"""A two-stage voxel detector of slice 11 through cli/train.py and
cli/test.py on the CPU: the Lyft Voxel R-CNN file with its tiny model
(tests/test_torch_voxel_rcnn.py), 512 points a scan and a 32 x 32 x 32
voxel grid on its range; 2 train steps at B = 2 with the RoI sampler's
seeded draws, every loss finite, then cli/test.py on the checkpoint.
SECOND-IoU and Part-A2 take the same CLI routes (``models/api.py``); their
CLIs run at full width in chip_smoke.py (a CLI run here costs 5-15 s of CPU
alone and several times that in the loaded test run: the sparse tables are
16000 voxels long whatever the points)."""
from __future__ import annotations

import copy

import numpy as np
import yaml

from modest_tpu_torch.configs import VOXEL_RCNN_DYNAMIC_OBJ_FULL
from modest_tpu_torch.utils.config import Config
from tests.test_torch_voxel_rcnn import voxelrcnn_model_cfg


def tiny_full_config(data_path):
    full = Config(copy.deepcopy(VOXEL_RCNN_DYNAMIC_OBJ_FULL))
    full.DATA_CONFIG.DATA_PATH = str(data_path)
    full.DATA_CONFIG.DATA_PROCESSOR[1].NUM_POINTS = {"train": 512, "test": 512}
    full.DATA_CONFIG.DATA_PROCESSOR[3].VOXEL_SIZE = [2.825, 2.5, 0.125]
    full.MODEL = voxelrcnn_model_cfg()
    full.OPTIMIZATION.LR = 0.002
    return full


def test_voxel_rcnn_train_and_test_clis(tmp_path):
    from modest_tpu_torch.cli import test as test_cli
    from modest_tpu_torch.cli import train as train_cli
    from modest_tpu_torch.data.kitti_dataset import create_kitti_infos
    from tests import synth_kitti

    synth_kitti.make_dataset(tmp_path, n_train=4, n_val=2, seed=3)
    full = tiny_full_config(tmp_path)
    create_kitti_infos(full.DATA_CONFIG, ["Dynamic"], tmp_path, tmp_path)
    cfg_file = tmp_path / "tiny_voxel_rcnn.yaml"
    cfg_file.write_text(yaml.safe_dump(full.to_dict()))
    out = tmp_path / "out"
    state = train_cli.main(["--cfg_file", str(cfg_file), "--batch_size", "2", "--epochs", "1",
                            "--fix_random_seed", "--device", "cpu", "--output_dir", str(out)])
    assert [r["step"] for r in state.history] == [0, 1]
    for rec in state.history:
        assert set(rec["metrics"]) == {"rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir", "loss",
                                       "grad_norm", "rcnn_loss_cls", "rcnn_loss_reg"}
        assert all(np.isfinite(v) for v in rec["metrics"].values())
    det_annos, results = test_cli.main(["--cfg_file", str(cfg_file), "--ckpt_dir",
                                        str(out / "ckpt"), "--batch_size", "2", "--workers",
                                        "0", "--device", "cpu", "--output_dir",
                                        str(tmp_path / "eval")])
    assert sorted(a["frame_id"] for a in det_annos) == ["000004", "000005"]
    assert all(np.isfinite(a["boxes_lidar"]).all() for a in det_annos)
    assert "roi_0.3" in results["recall"]
