"""The port's demo CLI and ``plot_bev`` on the CPU: analogues of
``tests/test_train_cli.py::test_demo_cli`` and ``test_plot_bev`` (the tiny
PointRCNN on tests/synth_kitti.py's velodyne files, BEV renders), the demo's
boxes against the eval path on the same frames, a checkpoint load, and the
CaDDN refusal."""
import copy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from modest_tpu_torch.cli import demo as demo_cli
from modest_tpu_torch.configs import POINTRCNN_DYNAMIC_OBJ_FULL
from modest_tpu_torch.models import api, build_network
from modest_tpu_torch.train.checkpoint import CheckpointManager
from modest_tpu_torch.train.optim import build_optimizer
from modest_tpu_torch.train.state import TrainState
from modest_tpu_torch.utils.config import Config

import synth_kitti
from test_pointrcnn_model import tiny_model_cfg
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def demo_env(tmp_path_factory):
    root = tmp_path_factory.mktemp("demo")
    synth_kitti.make_dataset(root, n_train=4, n_val=2, seed=3)
    full = Config(copy.deepcopy(POINTRCNN_DYNAMIC_OBJ_FULL))
    full.DATA_CONFIG.DATA_PROCESSOR[1].NUM_POINTS = {"train": 512, "test": 512}
    full.MODEL = tiny_model_cfg()
    cfg_file = root / "tiny_pointrcnn.yaml"
    with open(cfg_file, "w") as f:
        yaml.safe_dump(full.to_dict(), f)
    return root, cfg_file, full


def test_demo_cli(demo_env, tmp_path):
    """Raw .bin files through the eval path, BEV PNGs written (the JAX
    test's checks), and each frame's boxes those of ``api`` on the
    DemoDataset's frame with the same random weights."""
    root, cfg_file, full = demo_env
    save_dir = tmp_path / "demo_out"
    velodyne = root / "training" / "velodyne"
    np.random.seed(0)  # sample_points draws
    results = demo_cli.main(["--cfg_file", str(cfg_file), "--data_path", str(velodyne),
                             "--ext", ".bin", "--save_dir", str(save_dir), "--device", "cpu"])
    assert len(results) == 6  # 4 train + 2 val frames share the dir
    for r in results:
        assert r["boxes"].shape[1] == 7
        assert (save_dir / f"{r['frame_id']}.png").exists()

    dataset = demo_cli.DemoDataset(full.DATA_CONFIG, full.CLASS_NAMES, velodyne)
    model = build_network(full.MODEL, 1, device="cpu", seed=0, dataset=dataset)
    np.random.seed(0)
    for i, r in enumerate(results):
        points = torch.from_numpy(dataset[i]["points"][None].astype(np.float32))
        final = api.post_process(api.apply_eval(model, full.MODEL, points), full.MODEL)
        valid = final["valid"][0].numpy()
        np.testing.assert_array_equal(r["boxes"], final["boxes"][0].numpy()[valid][:, :7])
        np.testing.assert_array_equal(r["scores"], final["scores"][0].numpy()[valid])


def test_demo_loads_a_checkpoint(demo_env, tmp_path):
    """A checkpoint's weights (seed 7, not the demo's own seed 0): the
    demo's boxes are those of the eval path with those weights."""
    root, cfg_file, full = demo_env
    model = build_network(full.MODEL, 1, device="cpu", seed=7)
    opt = build_optimizer(model.parameters(), full.OPTIMIZATION, total_steps=1)
    CheckpointManager(tmp_path / "ckpt").save(TrainState(model, opt), 3)
    one = root / "training" / "velodyne" / "000001.bin"
    np.random.seed(0)
    got = demo_cli.main(["--cfg_file", str(cfg_file), "--data_path", str(one), "--device", "cpu",
                         "--ckpt_dir", str(tmp_path / "ckpt")])
    dataset = demo_cli.DemoDataset(full.DATA_CONFIG, full.CLASS_NAMES, one)
    np.random.seed(0)
    points = torch.from_numpy(dataset[0]["points"][None].astype(np.float32))
    final = api.post_process(api.apply_eval(model, full.MODEL, points), full.MODEL)
    valid = final["valid"][0].numpy()
    assert len(got) == 1 and valid.sum() > 0
    np.testing.assert_array_equal(got[0]["boxes"], final["boxes"][0].numpy()[valid][:, :7])
    np.testing.assert_array_equal(got[0]["scores"], final["scores"][0].numpy()[valid])


@pytest.mark.parametrize("stem", ["CaDDN", "CaDDN_deeplab"])
def test_demo_refuses_caddn(demo_env, stem):
    root = demo_env[0]
    with pytest.raises(SystemExit, match="lidar-only"):
        demo_cli.main(["--cfg_file", str(REPO / f"configs/models/kitti_models/{stem}.yaml"),
                       "--data_path", str(root / "training" / "velodyne"), "--device", "cpu"])


def test_plot_bev(tmp_path):
    """The JAX test's render, and the same PNG bytes as the JAX package's
    ``plot_bev`` draws."""
    from modest_tpu.utils.visualize import plot_bev as jplot_bev
    from modest_tpu_torch.utils.visualize import plot_bev

    rng = np.random.RandomState(0)
    pts = rng.uniform(0, 50, (1000, 3))
    boxes = np.array([[20, 0, 0, 4, 2, 1.5, 0.4]])
    out = tmp_path / "bev.png"
    plot_bev(pts, boxes=boxes, point_color=pts[:, 2], save_path=out)
    assert out.exists() and out.stat().st_size > 1000
    jplot_bev(pts, boxes=boxes, point_color=pts[:, 2], save_path=tmp_path / "jax_bev.png")
    assert out.read_bytes() == (tmp_path / "jax_bev.png").read_bytes()


def test_visualize_imports_matplotlib_only_when_plotting():
    code = ("import sys; import modest_tpu_torch.utils.visualize, modest_tpu_torch.cli.demo; "
            "assert 'matplotlib' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)
