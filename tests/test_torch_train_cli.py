"""The port's train CLI on tests/synth_kitti.py data with the tiny config on
the CPU: a run writes checkpoints and metrics, a second run resumes from
them, a pcdet-keyed .pth loads as a pretrained model, --eval_after_train
evaluates, and what cannot run (several processes without a rendezvous) or
is not present (CUDA) raises."""
import copy
import json
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from modest_tpu_torch.cli import train as train_cli
from modest_tpu_torch.configs import POINTRCNN_DYNAMIC_OBJ_FULL
from modest_tpu_torch.data.kitti_dataset import create_kitti_infos
from modest_tpu_torch.models import build_network
from modest_tpu_torch.train.checkpoint import CheckpointManager, load_params_partial
from modest_tpu_torch.train.metrics import MetricsLogger
from modest_tpu_torch.utils.config import Config

import synth_kitti
from test_pointrcnn_model import tiny_model_cfg
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tiny_env(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_train_cli")
    synth_kitti.make_dataset(root, n_train=4, n_val=1, seed=3)
    full = Config(copy.deepcopy(POINTRCNN_DYNAMIC_OBJ_FULL))
    full.DATA_CONFIG.DATA_PATH = str(root)
    full.DATA_CONFIG.DATA_PROCESSOR[1].NUM_POINTS = {"train": 512, "test": 512}
    create_kitti_infos(full.DATA_CONFIG, ["Dynamic"], root, root)
    full.MODEL = tiny_model_cfg()
    full.OPTIMIZATION.LR = 0.002
    cfg_file = root / "tiny_pointrcnn.yaml"
    with open(cfg_file, "w") as f:
        yaml.safe_dump(full.to_dict(), f)
    return root, cfg_file


def run(cfg_file, out_dir, epochs, *extra):
    return train_cli.main(["--cfg_file", str(cfg_file), "--batch_size", "2", "--epochs",
                           str(epochs), "--fix_random_seed", "--device", "cpu", "--output_dir",
                           str(out_dir), *extra])


def test_train_then_resume(tiny_env):
    root, cfg_file = tiny_env
    out = root / "out"
    state = run(cfg_file, out, 1)
    assert state.start_epoch == 0 and state.step == 2 and len(state.history) == 2
    for rec in state.history:
        assert rec["epoch"] == 0 and all(np.isfinite(v) for v in rec["metrics"].values())
        assert rec["metrics"]["point_pos_num"] > 1
    manager = CheckpointManager(out / "ckpt")
    assert manager.epochs() == [1]
    lines = [json.loads(line) for line in open(out / "metrics.jsonl")]
    assert [r["step"] for r in lines] == [0, 1] and "train/loss" in lines[0]

    resumed = run(cfg_file, out, 2)
    assert resumed.start_epoch == 1 and resumed.step == 4
    assert [r["epoch"] for r in resumed.history] == [1, 1]
    assert [r["step"] for r in resumed.history] == [2, 3]
    assert manager.epochs() == [1, 2]
    # the resumed run continued from the saved weights, not a fresh init
    saved = torch.load(manager.path(1), map_location="cpu")["model_state"]
    fresh = build_network(Config(tiny_model_cfg()), 1, device="cpu").state_dict()
    name = "point_head.cls_layers.0.weight"
    assert not torch.equal(saved[name], fresh[name])


def test_merge_all_iters_trains_one_pass(tiny_env, tmp_path):
    """--merge_all_iters_to_one_epoch: the merged loader already spans all
    epochs, so the run takes len(loader) steps in all (4 frames × 2 epochs
    at B = 2: 4 steps), with a checkpoint per epoch."""
    root, cfg_file = tiny_env
    state = run(cfg_file, tmp_path, 2, "--merge_all_iters_to_one_epoch")
    assert state.step == 4 and [r["epoch"] for r in state.history] == [0, 0, 1, 1]
    assert CheckpointManager(tmp_path / "ckpt").epochs() == [1, 2]


def test_checkpoints_rotate(tiny_env, tmp_path):
    root, cfg_file = tiny_env
    run(cfg_file, tmp_path, 3, "--max_ckpt_save_num", "2")
    assert CheckpointManager(tmp_path / "ckpt").epochs() == [2, 3]


def test_pretrained_pcdet_pth_loads_by_key(tiny_env, tmp_path):
    """A bare state dict with pcdet's keys, one extra key (pcdet's
    global_step) and one tensor of another shape: the rest loads."""
    root, cfg_file = tiny_env
    src = build_network(Config(tiny_model_cfg()), 1, device="cpu", seed=7).state_dict()
    pth = dict(src, global_step=torch.zeros(1, dtype=torch.long))
    pth["roi_head.reg_layers.3.weight"] = torch.zeros(5, 5)
    torch.save(pth, tmp_path / "pcdet.pth")
    model = build_network(Config(tiny_model_cfg()), 1, device="cpu", seed=0)
    loaded, skipped = load_params_partial(model, tmp_path / "pcdet.pth")
    assert (loaded, skipped) == (len(src) - 1, 1)
    got = model.state_dict()
    assert torch.equal(got["backbone_3d.SA_modules.0.mlps.0.0.weight"],
                       src["backbone_3d.SA_modules.0.mlps.0.0.weight"])
    assert not torch.equal(got["roi_head.reg_layers.3.weight"], src["roi_head.reg_layers.3.weight"])

    state = run(cfg_file, tmp_path / "out", 1, "--pretrained_model", str(tmp_path / "pcdet.pth"))
    assert state.step == 2


def test_eval_after_train_evaluates(tiny_env, tmp_path):
    """--eval_after_train evaluates the trained weights on the val split:
    result.pkl under eval/epoch_<E>/val with every val frame once."""
    root, cfg_file = tiny_env
    state = run(cfg_file, tmp_path, 1, "--eval_after_train")
    assert state.step == 2
    with open(tmp_path / "eval" / "epoch_1" / "val" / "result.pkl", "rb") as f:
        annos = pickle.load(f)
    assert [a["frame_id"] for a in annos] == ["000004"]
    assert {"boxes_lidar", "score", "location"} <= set(annos[0])


@pytest.mark.parametrize("extra,error,match", [
    (["--launcher", "manual", "--num_processes", "2"], ValueError, "coordinator address"),
    (["--launcher", "manual", "--num_devices", "2"], ValueError, "drives one device"),
])
def test_unported_options_raise(tiny_env, tmp_path, extra, error, match):
    """Multi-process training is ported (tests/test_torch_parallel*.py); what
    still raises: several processes without a rendezvous, and a launched
    process asked to start processes of its own."""
    root, cfg_file = tiny_env
    with pytest.raises(error, match=match):
        run(cfg_file, tmp_path, 1, *extra)


def test_the_default_device_is_the_card(tiny_env, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the refusal needs a host without one")
    root, cfg_file = tiny_env
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--cfg_file", str(cfg_file), "--output_dir", str(tmp_path)])


def test_the_shipped_config_needs_no_yaml():
    """--cfg_file naming the flagship YAML takes configs.py's dict: the CLI
    module and the config load import no PyYAML (nor PIL, JAX or tensorboard;
    torch itself imports tqdm where it is installed)."""
    code = ("import sys; from modest_tpu_torch.cli.train import load_model_config; "
            "c = load_model_config('configs/models/lyft_models/pointrcnn_dynamic_obj.yaml'); "
            "bad = [m for m in ('yaml', 'PIL', 'jax', 'tensorboard') if m in sys.modules]; "
            "print(c.OPTIMIZATION.OPTIMIZER, c.MODEL.NAME, bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         check=True, timeout=120).stdout.split()
    assert out == ["adam_onecycle", "PointRCNN", "[]"]


def test_metrics_logger_writes_jsonl(tmp_path):
    m = MetricsLogger(tmp_path)
    m.log(1, {"loss": 2.5, "lr": 0.01, "note": "skipped"}, prefix="train/")
    m.log(2, {"loss": torch.tensor(2.0)}, prefix="train/")
    m.close()
    lines = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert lines[0]["train/loss"] == 2.5 and "train/note" not in lines[0]
    assert lines[1] == {"step": 2, "time": lines[1]["time"], "train/loss": 2.0}


def test_metrics_logger_mirrors_to_tensorboard_when_it_can(tmp_path):
    """The scalars also go to TensorBoard where torch.utils.tensorboard
    imports (not on the card's machine); the JSONL is written either way."""
    try:
        import torch.utils.tensorboard  # noqa: F401
        importable = True
    except ImportError:
        importable = False
    m = MetricsLogger(tmp_path)
    m.log(3, {"loss": 1.5}, prefix="train/")
    m.close()
    assert json.loads(open(tmp_path / "metrics.jsonl").read())["train/loss"] == 1.5
    events = list((tmp_path / "tensorboard").glob("events.out.tfevents.*"))
    assert bool(events) == importable
