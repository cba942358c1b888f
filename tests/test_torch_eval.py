"""The port's detection eval against the JAX package on the CPU, and its
entry points.

At the tiny PointRCNN of tests/test_torch_slice.py (exact mode, the same
weights carried with state_dict_from_jax) on a small tools/synth_kitti.py
set, ``train/loop.py::eval_one_epoch`` and JAX's give the same frames in the
same order, once each although the last batch is wrap-padded, and >= 99% of
the boxes 1:1 (test_torch_slice._match_1to1). The recall counts and the AP
then agree within what the unmatched boxes allow: a box can change one
gt's recall at each threshold, and the AP by at most 100 / (valid gt) per
unmatched box for each recall sample it moves; with every box matched both
are equal. Then cli/test.py (``--ckpt_dir``, ``--eval_all`` over two
checkpoints, ``--torch_ckpt``) and its refusals: the card by default, a
card for each process (``--eval_after_train`` is in
tests/test_torch_train_cli.py).
"""
import copy
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from modest_tpu.data.loader import build_dataloader as j_build_dataloader
from modest_tpu.ops import pointnet2 as jp2
from modest_tpu.train.loop import eval_one_epoch as j_eval_one_epoch
from modest_tpu.train.state import TrainState as JTrainState
from modest_tpu.utils.config import Config as JConfig
from modest_tpu_torch.cli import test as test_cli
from modest_tpu_torch.configs import POINTRCNN_DYNAMIC_OBJ_FULL
from modest_tpu_torch.data.kitti_dataset import create_kitti_infos
from modest_tpu_torch.data.loader import build_dataloader
from modest_tpu_torch.models import api, build_network
from modest_tpu_torch.models.convert import state_dict_from_jax
from modest_tpu_torch.tools.synth_kitti import make_dataset
from modest_tpu_torch.train.checkpoint import CheckpointManager
from modest_tpu_torch.train.loop import eval_one_epoch
from modest_tpu_torch.train.state import create_train_state
from modest_tpu_torch.utils.config import Config

from test_pointrcnn_model import tiny_model_cfg
from test_torch_slice import _jax_model, _match_1to1, _tiny_model_cfg

N_VAL = 5  # at B = 2 the third batch is wrap-padded
RECALL = [0.3, 0.5, 0.7]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """A small KITTI-format set with infos (3 train, 5 val frames of ~4k
    points sampled to 512) and the flagship file with the tiny model, as a
    YAML config for the CLIs."""
    root = tmp_path_factory.mktemp("kitti_eval")
    make_dataset(root, n_train=3, n_val=N_VAL, seed=21)
    full = Config(copy.deepcopy(POINTRCNN_DYNAMIC_OBJ_FULL))
    full.DATA_CONFIG.DATA_PATH = str(root)
    full.DATA_CONFIG.DATA_PROCESSOR[1].NUM_POINTS = {"train": 512, "test": 512}
    create_kitti_infos(full.DATA_CONFIG, ["Dynamic"], root, root)
    full.MODEL = tiny_model_cfg()
    full.OPTIMIZATION.LR = 0.002
    cfg_file = root / "tiny_pointrcnn.yaml"
    with open(cfg_file, "w") as f:
        yaml.safe_dump(full.to_dict(), f)
    return root, full, cfg_file


@pytest.fixture(scope="module")
def exact_ops():
    """Exact mode is process-global (and clears jit caches): restore it."""
    prev = jp2.exact_ops()
    jp2.set_exact_ops(True)
    yield
    jp2.set_exact_ops(prev)


@pytest.fixture
def one_iou3d_shape(monkeypatch):
    """JAX's recall update calls its boxes_iou3d eagerly on each frame's own
    (detections, gt) shape, an XLA compile per shape; pad both sides to one
    shape and cut the result back, which changes no IoU."""
    import jax

    from modest_tpu.ops import iou3d as j_iou3d

    fn = jax.jit(j_iou3d.boxes_iou3d)

    def pad(boxes, n):
        out = jnp.zeros((n, boxes.shape[1]), boxes.dtype).at[:, 3:6].set(1.0).at[:, 0].set(1e4)
        return out.at[:boxes.shape[0]].set(boxes)

    monkeypatch.setattr(j_iou3d, "boxes_iou3d", lambda a, b: fn(pad(a, 512), pad(b, 64))[
        :a.shape[0], :b.shape[0]])


def test_eval_one_epoch_matches_jax(env, exact_ops, one_iou3d_shape, tmp_path):
    root, full, _ = env
    model_cfg = dict(_tiny_model_cfg())
    model_cfg["POST_PROCESSING"] = dict(model_cfg["POST_PROCESSING"], RECALL_THRESH_LIST=RECALL)
    jmodel, params, stats = _jax_model(model_cfg)
    cfg = Config(model_cfg)
    port = build_network(cfg, 1, device="cpu")
    port.load_state_dict(state_dict_from_jax(params, stats), strict=True)

    data_cfg = full.DATA_CONFIG
    eval_set, loader = build_dataloader(data_cfg, ["Dynamic"], 2, training=False)
    j_set, j_loader = j_build_dataloader(JConfig(data_cfg.to_dict()), ["Dynamic"], 2,
                                         training=False)
    batches, j_batches = list(loader), list(j_loader)
    assert len(batches) == len(j_batches) == 3
    for b, jb in zip(batches, j_batches):  # the same input points
        assert b["frame_id"] == jb["frame_id"]
        np.testing.assert_array_equal(b["points"], jb["points"])

    annos, ret = eval_one_epoch(port, cfg, loader, eval_set, ["Dynamic"], device="cpu",
                                result_dir=tmp_path / "port")
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                        opt_state=None)
    j_annos, j_ret = j_eval_one_epoch(jmodel, JConfig(model_cfg), state, j_loader, j_set,
                                      ["Dynamic"], result_dir=tmp_path / "jax")

    ids = [a["frame_id"] for a in annos]
    assert ids == [a["frame_id"] for a in j_annos] == [f"{i:06d}" for i in range(3, 3 + N_VAL)]
    with open(tmp_path / "port" / "result.pkl", "rb") as f:
        assert [a["frame_id"] for a in pickle.load(f)] == ids

    total = matched = 0
    for a, ja in zip(annos, j_annos):
        assert isinstance(a["boxes_lidar"], np.ndarray) and isinstance(a["score"], np.ndarray)
        pairs = _match_1to1(a["boxes_lidar"], a["score"], ja["boxes_lidar"], ja["score"])
        for i, j in pairs:
            np.testing.assert_allclose(a["location"][i], ja["location"][j], atol=2e-2)
            assert a["name"][i] == ja["name"][j]
        matched += len(pairs)
        total += max(len(a["score"]), len(ja["score"]))
    assert total >= 20, f"only {total} detections: the comparison is vacuous"
    assert matched / total >= 0.99, f"only {matched}/{total} boxes match JAX's"
    unmatched = total - matched

    rec, j_rec = ret["recall"], j_ret["recall"]
    assert rec.keys() == j_rec.keys() and rec["gt"] == j_rec["gt"] > 0
    for k in rec:
        assert abs(rec[k] - j_rec[k]) <= unmatched, k
    ap_keys = [k for k in j_ret if k.endswith("_R40")]
    assert ap_keys and set(ap_keys) <= set(ret)
    n_gt = rec["gt"]
    for k in ap_keys:
        assert abs(ret[k] - j_ret[k]) <= 100 * unmatched / n_gt + 1e-9, k
    assert ret["sec_per_example"] > 0
    assert ret["steady_sec_per_example"] > 0  # 3 batches: the last 2 are timed


def test_the_wrap_padded_tail_adds_nothing(env):
    """At B = 2 the third batch repeats frame 3 after frame 7, with points
    sampled anew (each batch draws from its own seed), so its boxes differ
    from frame 3's first pass: the annos keep the first pass, once, and the
    recall counts frame 3's gt boxes once."""
    _, full, _ = env
    model_cfg = Config(tiny_model_cfg())
    model = build_network(model_cfg, 1, device="cpu", seed=4)
    eval_set, loader = build_dataloader(full.DATA_CONFIG, ["Dynamic"], 2, training=False)
    batches = list(loader)
    assert batches[-1]["frame_id"] == ["000007", "000003"]
    annos, ret = eval_one_epoch(model, model_cfg, loader, eval_set, ["Dynamic"], device="cpu")
    assert [a["frame_id"] for a in annos] == [f"{i:06d}" for i in range(3, 3 + N_VAL)]

    def boxes(batch, row):
        final = api.post_process(api.apply_eval(model, model_cfg,
                                                torch.from_numpy(batch["points"])), model_cfg)
        return final["boxes"][row][final["valid"][row]].numpy()

    first, again = boxes(batches[0], 0), boxes(batches[-1], 1)
    assert first.shape != again.shape or not np.allclose(first, again)
    np.testing.assert_allclose(annos[0]["boxes_lidar"], first, rtol=0, atol=1e-6)
    n_gt = sum(int((np.abs(b["gt_boxes"][i]).sum(-1) > 0).sum())
               for bi, b in enumerate(batches) for i in range(2)
               if (bi, i) != (len(batches) - 1, 1))
    assert ret["recall"]["gt"] == n_gt > 0


@pytest.fixture(scope="module")
def ckpts(env, tmp_path_factory):
    """Two checkpoints of the train CLI's layout (epochs 1 and 2, other
    weights) and a bare pcdet-keyed state dict."""
    _, full, _ = env
    out = tmp_path_factory.mktemp("ckpts")
    manager = CheckpointManager(out / "ckpt")
    for epoch in (1, 2):
        model = build_network(Config(full.MODEL), 1, device="cpu", seed=epoch)
        manager.save(create_train_state(model, full.OPTIMIZATION, 10), epoch)
    torch.save(build_network(Config(full.MODEL), 1, device="cpu", seed=3).state_dict(),
               out / "pcdet.pth")
    return out


def _test(cfg_file, out, *extra):
    return test_cli.main(["--cfg_file", str(cfg_file), "--batch_size", "2", "--workers", "0",
                          "--device", "cpu", "--output_dir", str(out), *extra])


def _check_result(result_dir):
    with open(result_dir / "result.pkl", "rb") as f:
        annos = pickle.load(f)
    assert [a["frame_id"] for a in annos] == [f"{i:06d}" for i in range(3, 3 + N_VAL)]


def test_test_cli_ckpt_dir(env, ckpts, tmp_path):
    _, _, cfg_file = env
    annos, ret = _test(cfg_file, tmp_path, "--ckpt_dir", str(ckpts / "ckpt"), "--ckpt_epoch", "1")
    _check_result(tmp_path / "eval" / "epoch_1" / "val")
    assert len(annos) == N_VAL and "Dynamic_bev_iou0.7/00-80_R40" in ret
    assert ret["recall"]["gt"] > 0
    # the latest epoch when none is named, and the same weights give the same boxes
    annos2, _ = _test(cfg_file, tmp_path / "b", "--ckpt_dir", str(ckpts / "ckpt"))
    _check_result(tmp_path / "b" / "eval" / "epoch_2" / "val")
    again, _ = _test(cfg_file, tmp_path / "c", "--ckpt_dir", str(ckpts / "ckpt"),
                     "--ckpt_epoch", "2", "--save_to_file")
    for a, b in zip(annos2, again):
        np.testing.assert_array_equal(a["boxes_lidar"], b["boxes_lidar"])
    assert (tmp_path / "c" / "eval" / "epoch_2" / "val" / "000003.txt").exists()


def test_test_cli_eval_all(env, ckpts, tmp_path):
    """--eval_all walks both checkpoints, keeps the record, and a second run
    finds nothing new (no wait: --max_waiting_mins 0)."""
    _, _, cfg_file = env
    args = ("--ckpt_dir", str(ckpts / "ckpt"), "--eval_all", "--max_waiting_mins", "0")
    annos, _ = _test(cfg_file, tmp_path, *args)
    assert len(annos) == N_VAL
    for epoch in (1, 2):
        _check_result(tmp_path / "eval" / f"epoch_{epoch}" / "val")
    record = tmp_path / "eval" / "eval_list_val.txt"
    assert record.read_text() == "1\n2\n"
    assert _test(cfg_file, tmp_path, *args) is None
    assert record.read_text() == "1\n2\n"


def test_test_cli_torch_ckpt(env, ckpts, tmp_path):
    _, _, cfg_file = env
    annos, _ = _test(cfg_file, tmp_path, "--torch_ckpt", str(ckpts / "pcdet.pth"))
    _check_result(tmp_path / "eval" / "epoch_torch_ckpt" / "val")
    # the weights were loaded: they differ from the checkpoints' and from a fresh init
    ref, _ = _test(cfg_file, tmp_path / "b", "--ckpt_dir", str(ckpts / "ckpt"),
                   "--ckpt_epoch", "1")
    assert any(len(a["score"]) != len(b["score"]) or not np.array_equal(a["score"], b["score"])
               for a, b in zip(annos, ref))


@pytest.mark.parametrize("extra,error,match", [
    (["--ckpt_dir", "ckpt"], RuntimeError, "CUDA is not available"),
    (["--ckpt_dir", "ckpt", "--num_devices", "2"], RuntimeError, "CUDA cards are visible"),
    (["--device", "cpu"], ValueError, "--ckpt_dir or --torch_ckpt"),
])
def test_test_cli_refusals(env, tmp_path, extra, error, match):
    """The card by default (raises without CUDA unless --device cpu), a
    card for each of --num_devices, and a checkpoint is required."""
    if error is RuntimeError and torch.cuda.is_available():
        pytest.skip("this host has a card; the refusal needs a host without one")
    _, _, cfg_file = env
    with pytest.raises(error, match=match):
        test_cli.main(["--cfg_file", str(cfg_file), "--output_dir", str(tmp_path), *extra])
