"""The grid detectors through the port's CLIs on the CPU: cli/train.py (train,
checkpoint, resume) and cli/test.py (evaluate a checkpoint) on the tiny
PointPillars and SECOND configs of tests/test_torch_grid_detectors.py over
tests/synth_kitti.py data, with each Lyft config's data section at a coarse
32 x 32 grid; and one round of cli/self_train.py with the tiny PointPillars
on the three-traversal world of tests/test_torch_self_train.py."""
import copy
import pickle

import numpy as np
import pytest
import torch
import yaml

from modest_tpu_torch.cli import self_train
from modest_tpu_torch.cli import test as test_cli
from modest_tpu_torch.cli import train as train_cli
from modest_tpu_torch.configs import POINTPILLAR_DYNAMIC_OBJ_FULL, SECOND_DYNAMIC_OBJ_FULL
from modest_tpu_torch.data.kitti_dataset import create_kitti_infos
from modest_tpu_torch.train.checkpoint import FORMAT, CheckpointManager
from modest_tpu_torch.utils.config import Config

import synth_kitti
from test_torch_grid_detectors import pillar_model_cfg, second_model_cfg
from test_torch_self_train import seeded  # noqa: F401  (the module fixture)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# voxel sizes that give a 32 x 32 (x 32) grid on each config's range
TINY = {"pointpillar": (POINTPILLAR_DYNAMIC_OBJ_FULL, pillar_model_cfg, [2.8, 2.48, 4]),
        "second": (SECOND_DYNAMIC_OBJ_FULL, second_model_cfg, [2.825, 2.5, 0.125])}


def tiny_full_config(name, data_path):
    full_cfg, model_cfg, voxel = TINY[name]
    full = Config(copy.deepcopy(full_cfg))
    full.DATA_CONFIG.DATA_PATH = str(data_path)
    full.DATA_CONFIG.DATA_PROCESSOR[1].NUM_POINTS = {"train": 512, "test": 512}
    full.DATA_CONFIG.DATA_PROCESSOR[3].VOXEL_SIZE = voxel
    full.MODEL = model_cfg()
    full.OPTIMIZATION.LR = 0.002
    return full


@pytest.fixture(scope="module")
def grid_env(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_grid_cli")
    synth_kitti.make_dataset(root, n_train=4, n_val=2, seed=3)
    files = {}
    for name in TINY:
        full = tiny_full_config(name, root)
        files[name] = root / f"tiny_{name}.yaml"
        with open(files[name], "w") as f:
            yaml.safe_dump(full.to_dict(), f)
    create_kitti_infos(full.DATA_CONFIG, ["Dynamic"], root, root)
    return root, files


def train(cfg_file, out, epochs, *extra):
    return train_cli.main(["--cfg_file", str(cfg_file), "--batch_size", "2", "--epochs",
                           str(epochs), "--fix_random_seed", "--device", "cpu", "--output_dir",
                           str(out), *extra])


@pytest.mark.parametrize("name", ["pointpillar", "second"])
def test_train_resume_and_test(grid_env, name, tmp_path):
    root, files = grid_env
    out = tmp_path / "out"
    state = train(files[name], out, 1)
    assert state.step == 2 and len(state.history) == 2
    for rec in state.history:
        assert set(rec["metrics"]) == {"rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir", "loss",
                                       "grad_norm"}
        assert all(np.isfinite(v) for v in rec["metrics"].values())
    manager = CheckpointManager(out / "ckpt")
    assert manager.epochs() == [1]
    saved = torch.load(manager.path(1), map_location="cpu")
    assert saved["format"] == FORMAT
    assert not any(k.endswith("anchors") for k in saved["model_state"])

    resumed = train(files[name], out, 2)
    assert resumed.start_epoch == 1 and [r["step"] for r in resumed.history] == [2, 3]
    assert manager.epochs() == [1, 2]

    det_annos, results = test_cli.main(["--cfg_file", str(files[name]), "--ckpt_dir",
                                        str(out / "ckpt"), "--batch_size", "2", "--workers",
                                        "0", "--device", "cpu", "--output_dir",
                                        str(tmp_path / "eval")])
    assert sorted(a["frame_id"] for a in det_annos) == ["000004", "000005"]
    assert (tmp_path / "eval" / "eval" / "epoch_2" / "val" / "result.pkl").exists()
    assert results["recall"].get("gt", 0) > 0 and "roi_0.3" not in results["recall"]


def test_set_lr_caps_the_one_cycle(grid_env, tmp_path):
    """``--set OPTIMIZATION.LR`` after ``--epochs``, as chip_smoke.py trains
    the grid detectors: the one-cycle over the run's steps peaks at the rate
    set, and a resume from the last-but-one epoch goes on at the same rates."""
    root, files = grid_env
    lr = 5e-4
    full = train(files["pointpillar"], tmp_path / "full", 3, "--set", "OPTIMIZATION.LR", str(lr))
    rates = [full.optimizer.lr_fn(k) for k in range(6)]
    assert max(rates) == pytest.approx(lr, rel=1e-6) and min(rates) < lr / 9
    assert full.optimizer.current_lr() == pytest.approx(float(full.optimizer.lr_fn(6)))
    ckpt = tmp_path / "part" / "ckpt"
    ckpt.mkdir(parents=True)
    (ckpt / "checkpoint_epoch_2.pth").write_bytes(
        (tmp_path / "full" / "ckpt" / "checkpoint_epoch_2.pth").read_bytes())
    resumed = train(files["pointpillar"], tmp_path / "part", 3,
                    "--set", "OPTIMIZATION.LR", str(lr))
    assert resumed.start_epoch == 2 and [r["step"] for r in resumed.history] == [4, 5]
    assert [r["metrics"] for r in resumed.history] == [r["metrics"] for r in full.history[4:]]


def test_self_train_round_with_pointpillars(seeded, tmp_path):  # noqa: F811
    """One round of the driver with the tiny PointPillars: labels fused, the
    round trained, the train split inferred (every frame once)."""
    root, _ = seeded
    full = tiny_full_config("pointpillar", root)
    cfg_file = tmp_path / "tiny_pointpillar.yaml"
    with open(cfg_file, "w") as f:
        yaml.safe_dump(full.to_dict(), f)
    out_root = tmp_path / "st_out"
    timings = self_train.main([
        "--cfg_file", str(cfg_file), "--base_data", str(root), "--work_dir", str(root),
        "--seed_result", str(root / "seed_result.pkl"), "--max_iter", "1",
        "--output_root", str(out_root), "--rounds_dir", str(out_root / "rounds"),
        "--batch_size", "1", "--epochs", "1", "--num_devices", "1", "--device", "cpu"])
    assert list(timings) == ["round_1"]
    with open(out_root / "round_1" / "eval_train" / "result.pkl", "rb") as f:
        annos = pickle.load(f)
    assert [a["frame_id"] for a in annos] == ["000000", "000001", "000002"]
    assert CheckpointManager(out_root / "round_1" / "ckpt").epochs() == [1]
