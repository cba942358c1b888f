"""The port's entry points in two processes on the CPU (``--num_devices 2
--device cpu``: two spawned processes of one gloo group): cli/train.py end
to end with ``--eval_after_train`` on the tiny PointRCNN, and one round of
cli/self_train.py, which hands ``--num_devices`` to cli/train.py and
cli/test.py.

Each CLI runs as a subprocess in a session of its own, bounded by
TIMEOUT_S (the whole session is killed past it, the spawned processes
with it). The subprocesses find a stub ``tensorboard`` package first on
their path, one that raises ImportError, so ``train/metrics.py`` writes its
JSONL alone, as on the card's machine, which has no tensorboard: the real
one imports TensorFlow, which costs more than the rest of a run.
"""
import copy
import json
import os
import pickle
import signal
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

from modest_tpu_torch.configs import POINTRCNN_DYNAMIC_OBJ_FULL
from modest_tpu_torch.data.kitti_dataset import create_kitti_infos
from modest_tpu_torch.tools.synth_kitti import make_dataset
from modest_tpu_torch.utils.config import Config

from test_pointrcnn_model import tiny_model_cfg
from test_torch_self_train import N_FRAMES, _driver_args, seeded  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 240


def run_cli(module, args, tmp_path):
    stub = tmp_path / "stubs" / "tensorboard"
    stub.mkdir(parents=True, exist_ok=True)
    (stub / "__init__.py").write_text('raise ImportError("no tensorboard in these runs")\n')
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(stub.parent), str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen([sys.executable, "-m", module, *map(str, args)], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail(f"{module} did not end within {TIMEOUT_S} s:\n{out[-4000:]}")
    assert proc.returncode == 0, out[-4000:]
    return out


def test_train_cli_in_two_processes(tmp_path):
    """2 epochs at a global batch of 2 (1 a process) on 4 train frames, then
    the merged evaluation of 3 val frames: rank 0 alone wrote the
    checkpoints, the metrics (one record a step) and the log; result.pkl
    holds every val frame once, in order."""
    root = tmp_path / "data"
    make_dataset(root, n_train=4, n_val=3, seed=3)
    full = Config(copy.deepcopy(POINTRCNN_DYNAMIC_OBJ_FULL))
    full.DATA_CONFIG.DATA_PATH = str(root)
    full.DATA_CONFIG.DATA_PROCESSOR[1].NUM_POINTS = {"train": 512, "test": 512}
    create_kitti_infos(full.DATA_CONFIG, ["Dynamic"], root, root)
    full.MODEL = tiny_model_cfg()
    full.OPTIMIZATION.LR = 0.002
    cfg_file = root / "tiny.yaml"
    with open(cfg_file, "w") as f:
        yaml.safe_dump(full.to_dict(), f)

    out = tmp_path / "out"
    log = run_cli("modest_tpu_torch.cli.train", [
        "--cfg_file", cfg_file, "--batch_size", 2, "--epochs", 2, "--fix_random_seed",
        "--device", "cpu", "--num_devices", 2, "--output_dir", out, "--eval_after_train"],
        tmp_path)
    assert "2 processes, backend gloo" in log
    assert sorted(p.name for p in (out / "ckpt").iterdir()) == [
        "checkpoint_epoch_1.pth", "checkpoint_epoch_2.pth"]
    assert len(list(out.glob("log_train_*.txt"))) == 1
    records = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [0, 1, 2, 3]
    with open(out / "eval" / "epoch_2" / "val" / "result.pkl", "rb") as f:
        assert [a["frame_id"] for a in pickle.load(f)] == ["000004", "000005", "000006"]


def test_self_train_round_in_two_processes(seeded, tmp_path):  # noqa: F811
    """One round with ``--num_devices 2 --device cpu`` at a global batch of
    2: the round's checkpoint and its train-split result.pkl with every
    frame once."""
    args = _driver_args(seeded, tmp_path / "st_out", 1)
    args[args.index("--batch_size") + 1] = "2"
    args[args.index("--num_devices") + 1] = "2"
    run_cli("modest_tpu_torch.cli.self_train", args, tmp_path)
    round_out = tmp_path / "st_out" / "round_1"
    assert (round_out / "ckpt" / "checkpoint_epoch_1.pth").exists()
    with open(round_out / "eval_train" / "result.pkl", "rb") as f:
        assert [a["frame_id"] for a in pickle.load(f)] == [f"{g:06d}" for g in range(N_FRAMES)]
