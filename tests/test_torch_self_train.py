"""The port's self-training driver (modest_tpu_torch/cli/self_train.py) on the
CPU at the tiny PointRCNN: tests/test_self_train_driver.py's checks (two
rounds, the resume that skips a finished round, the kill-and-resume mid
round, the round dataset's symlinks), on a world of three traversals made
by tools/pipeline_scenes.py and seeded by the port's own PP, seed-mask and
label-file CLIs. The port's round-1 result.pkl then feeds the JAX
package's combine_labels CLI, which must write the labels the port wrote
for round 2.
"""
import copy
import pickle
import shutil

import numpy as np
import pytest
import yaml

from modest_tpu.cli import combine_labels as j_combine_labels
from modest_tpu_torch.cli import (generate_label_files, generate_mask, pre_compute_pp_score,
                                  self_train)
from modest_tpu_torch.configs import POINTRCNN_DYNAMIC_OBJ_FULL
from modest_tpu_torch.tools.pipeline_scenes import write_dataset
from modest_tpu_torch.utils import kitti_io
from modest_tpu_torch.utils.config import Config

from test_pointrcnn_model import tiny_model_cfg
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

N_FRAMES = 3


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    """Three traversals of one road (ground and a wall seen every time), each
    frame with its own car; the seed stages on the CPU, and a round-0
    detector result.pkl near the planted cars."""
    rng = np.random.RandomState(7)
    root = tmp_path_factory.mktemp("selftrain")
    ground = np.stack([rng.uniform(0, 60, 5000), rng.uniform(-20, 20, 5000),
                       np.full(5000, -1.8)], 1)
    wall = np.stack([rng.uniform(30, 34, 800), np.full(800, -12.0), rng.uniform(-1.8, 1.2, 800)],
                    1)
    frames, cars = {}, {}
    for gid in range(N_FRAMES):
        cx, cy = rng.uniform(12, 30), rng.uniform(-2, 2)
        car = rng.uniform(0, 1, (500, 3)) * [4.2, 1.8, 1.5] + [cx, cy, -1.79]
        cars[gid] = (cx + 2.1, cy + 0.9)
        static = np.concatenate([ground, wall]) + rng.randn(5800, 3) * 0.01
        frames[gid] = np.concatenate([static, car])
    # each origin looks at the other traversals
    valid_idx = {g: (g, 0, [(o, [0]) for o in range(N_FRAMES) if o != g])
                 for g in range(N_FRAMES)}
    write_dataset(root, frames, [[g] for g in range(N_FRAMES)], valid_idx)
    ov = [f"work_dir={root}", f"data_root={root / 'training'}", "device=cpu"]
    pre_compute_pp_score.main(ov)
    generate_mask.main(ov + ["graph.n_neighbors=30"])
    generate_label_files.main(ov + ["fov_only=true"])

    dets = []
    for g in range(N_FRAMES):
        cx, cy = cars[g]  # camera-rect: x = -lidar y, z = lidar x
        dets.append({
            "frame_id": f"{g:06d}",
            "name": np.array(["Dynamic"]),
            "location": np.array([[-cy, -0.3, cx]], np.float32),
            "dimensions": np.array([[4.2, 1.5, 1.8]], np.float32),  # l h w
            "rotation_y": np.array([0.0], np.float32),
            "score": np.array([0.9], np.float32),
        })
    with open(root / "seed_result.pkl", "wb") as f:
        pickle.dump(dets, f)

    full = Config(copy.deepcopy(POINTRCNN_DYNAMIC_OBJ_FULL))
    full.DATA_CONFIG.DATA_PROCESSOR[1].NUM_POINTS = {"train": 512, "test": 512}
    full.MODEL = tiny_model_cfg()
    full.OPTIMIZATION.LR = 0.002
    cfg_file = root / "tiny.yaml"
    with open(cfg_file, "w") as f:
        yaml.safe_dump(full.to_dict(), f)
    return root, cfg_file


def _driver_args(seeded, out_root, max_iter):
    root, cfg_file = seeded
    return ["--cfg_file", str(cfg_file), "--base_data", str(root), "--work_dir", str(root),
            "--seed_result", str(root / "seed_result.pkl"), "--max_iter", str(max_iter),
            "--output_root", str(out_root), "--rounds_dir", str(out_root / "rounds"),
            "--batch_size", "1", "--epochs", "1", "--num_devices", "1",
            "--device", "cpu"]


def _texts(d):
    return {p.name: p.read_text() for p in sorted(d.glob("*.txt"))}


def test_self_train_driver_two_rounds_with_resume(seeded, tmp_path):
    root = seeded[0]
    out_root = tmp_path / "st_out"

    # ---- round 1 ----
    timings = self_train.main(_driver_args(seeded, out_root, 1))
    assert list(timings) == ["round_1"]
    assert list(timings["round_1"]) == ["combine", "round_dataset", "infos", "train",
                                        "inference"]
    r1_result = out_root / "round_1" / "eval_train" / "result.pkl"
    with open(r1_result, "rb") as f:
        annos = pickle.load(f)
    assert [a["frame_id"] for a in annos] == [f"{g:06d}" for g in range(N_FRAMES)]
    assert all(isinstance(a["location"], np.ndarray) for a in annos)

    label_tok = self_train.token(root / "intermediate_results" / "round_1_labels")
    data_tok = self_train.token(out_root / "rounds" / "round_1")
    assert label_tok.exists() and data_tok.exists()
    # fused labels exist and the round dataset points label_2 at them
    training = out_root / "rounds" / "round_1" / "training"
    assert training.joinpath("label_2").is_symlink()
    for sub in ("velodyne", "calib", "image_2", "planes"):
        assert training.joinpath(sub).is_symlink(), sub
    assert (out_root / "rounds" / "round_1" / "ImageSets").is_symlink()
    for g in range(N_FRAMES):
        assert len(kitti_io.read_label(training / "label_2" / f"{g:06d}.txt")) >= 1

    mt_label, mt_data = label_tok.stat().st_mtime_ns, data_tok.stat().st_mtime_ns
    mt_r1 = r1_result.stat().st_mtime_ns

    # ---- resume into round 2: round 1 is skipped whole ----
    timings = self_train.main(_driver_args(seeded, out_root, 2))
    assert list(timings) == ["round_2"]
    assert label_tok.stat().st_mtime_ns == mt_label
    assert data_tok.stat().st_mtime_ns == mt_data
    assert r1_result.stat().st_mtime_ns == mt_r1
    r2_result = out_root / "round_2" / "eval_train" / "result.pkl"
    assert r2_result.exists()
    r2_labels = root / "intermediate_results" / "round_2_labels"
    r2_label_tok = self_train.token(r2_labels)
    assert r2_label_tok.exists()

    # ---- the port's round-1 result.pkl through JAX's combine_labels ----
    j_labels = tmp_path / "jax_round_2_labels"
    j_combine_labels.main([f"work_dir={root}", "data_paths=fw70_2m",
                           f"data_root={root}/training", "fov_only=true",
                           f"det_result_path={r1_result}", f"save_path={j_labels}"])
    assert _texts(j_labels) == _texts(r2_labels)
    assert len(_texts(r2_labels)) == N_FRAMES

    # ---- kill-and-resume mid round: round 2's training outputs go, its
    # label and data tokens stay → labels are not remade, training is
    mt2_label = r2_label_tok.stat().st_mtime_ns
    shutil.rmtree(out_root / "round_2" / "eval_train_root")
    r2_result.unlink()
    shutil.rmtree(out_root / "round_2" / "ckpt")
    timings = self_train.main(_driver_args(seeded, out_root, 2))
    assert list(timings) == ["round_2"]
    assert r2_label_tok.stat().st_mtime_ns == mt2_label
    assert r2_result.exists()


def test_the_driver_runs_on_the_card_unless_asked_for_the_cpu(seeded, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card; the refusal needs a host without one")
    args = _driver_args(seeded, tmp_path, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        self_train.main(args[:args.index("--device")])
