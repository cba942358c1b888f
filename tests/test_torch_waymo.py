"""The port's Waymo data layer (``data/waymo_dataset.py``,
``tools/synth_infos.py``) against the JAX package's, on the same seeded
trees: items (the NLZ points dropped, ``tanh`` on the intensity, the
``unknown`` boxes dropped, SAMPLED_INTERVAL), the PV-RCNN config's training
batches (gt sampling, the world augmentations), the evaluation under
``EVAL_METRIC`` ``kitti`` and ``waymo``, the gt database, and the
TensorFlow gate."""
from __future__ import annotations

import copy
import filecmp
import pickle
import shutil

import numpy as np
import pytest

from modest_tpu.data import loader as jloader
from modest_tpu.data import waymo_dataset as jwd
from modest_tpu.utils.config import Config as JConfig
from modest_tpu_torch import configs
from modest_tpu_torch.data import loader as tloader
from modest_tpu_torch.data import waymo_dataset as twd
from modest_tpu_torch.tools import synth_infos
from modest_tpu_torch.utils.config import Config
from tests.test_nuscenes_waymo import WAYMO_CFG, make_waymo_tree
from tests.test_torch_data import assert_same
from tests.test_torch_nuscenes import trees_equal

NAMES = configs.WAYMO_CLASS_NAMES
FULL_POINTS = 6000
NUM_POINTS = 4096
DB = "pcdet_waymo_dbinfos_train_sampled_1.pkl"


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The tiny tree and a small full-density tree (6 train, 3 val frames),
    each package's gt database (every frame) written into its own copy."""
    base = tmp_path_factory.mktemp("waymo")
    synth_infos.write_waymo_tree(base / "tiny", rng=np.random.RandomState(0))
    synth_infos.write_waymo_tree(base / "jax", 6, rng=np.random.RandomState(1),
                                 full_density=True, n_val=3, points=FULL_POINTS)
    shutil.copytree(base / "jax", base / "torch")
    for side, mod, conf in (("jax", jwd, JConfig), ("torch", twd, Config)):
        cfg = conf({**configs.WAYMO_DATASET_BASE, "SAMPLED_INTERVAL": {"train": 1, "test": 1},
                    "DATA_SPLIT": {"train": "train", "test": "train"}})
        ds = mod.WaymoDataset(cfg, NAMES, training=False, root_path=base / side)
        ds.create_groundtruth_database(split="train", sampled_interval=1)
    return base


def test_tiny_tree_is_make_waymo_tree(tmp_path):
    make_waymo_tree(tmp_path / "a", n_frames=5, rng=np.random.RandomState(3))
    synth_infos.write_waymo_tree(tmp_path / "b", n_frames=5, rng=np.random.RandomState(3))
    assert trees_equal(tmp_path / "a", tmp_path / "b") == 2 + 5


def test_items_match_jax(roots):
    """Training items of the tiny tree and test items of the full one equal
    JAX's: (N, 5) points with no NLZ point left and ``tanh`` on the
    intensity, the ``unknown`` boxes gone."""
    for root, training, n in ((roots / "tiny", True, 2), (roots / "torch", False, 3)):
        cfg = dict(WAYMO_CFG, DATA_SPLIT={"train": "train", "test": "val"})
        items = {}
        for side, mod, conf in (("jax", jwd, JConfig), ("torch", twd, Config)):
            np.random.seed(4)
            ds = mod.WaymoDataset(conf(cfg), NAMES, training=training, root_path=root)
            assert len(ds) == n
            items[side] = [ds[i] for i in range(len(ds))]
        assert_same(items["torch"], items["jax"])
        assert all(item["gt_boxes"].shape[1] == 8 for item in items["torch"])
    ds = twd.WaymoDataset(Config(dict(WAYMO_CFG, DATA_SPLIT={"train": "train", "test": "val"})),
                          NAMES, training=False, root_path=roots / "torch")
    info = ds.infos[0]["point_cloud"]
    raw = np.load(roots / "torch" / "waymo_processed_data" / info["lidar_sequence"]
                  / f"{info['sample_idx']:04d}.npy")
    got = ds.get_lidar(info["lidar_sequence"], info["sample_idx"])
    keep = raw[:, 5] == -1
    assert 0 < (~keep).sum() < len(raw) and got.shape == (keep.sum(), 5)
    np.testing.assert_array_equal(got[:, 3], np.tanh(raw[keep, 3]))
    assert (np.asarray(ds.infos[0]["annos"]["name"]) == "unknown").any()


def _pv_data_cfg(root, conf):
    cfg = copy.deepcopy(configs.WAYMO_CONFIGS["pv_rcnn"]["DATA_CONFIG"])
    cfg["DATA_PATH"] = str(root)
    cfg["SAMPLED_INTERVAL"] = {"train": 1, "test": 1}
    cfg["DATA_PROCESSOR"][1]["NUM_POINTS"] = {"train": NUM_POINTS, "test": NUM_POINTS}
    cfg["DATA_AUGMENTOR"]["AUG_CONFIG_LIST"][0]["DB_INFO_PATH"] = [DB]
    return conf(cfg)


def test_pv_rcnn_training_batches_match_jax(roots):
    """The shipped Waymo PV-RCNN data config at 4096 points a scan: gt
    sampling (``filter_by_difficulty`` reads the database's difficulty),
    flips on x and y, rotation, scaling; both read the port's database.
    Two epochs of batches equal JAX's."""
    shutil.copy(roots / "torch" / DB, roots / "jax" / "port_db.pkl")
    batches = {}
    for side, mod, conf in (("jax", jloader, JConfig), ("torch", tloader, Config)):
        cfg = _pv_data_cfg(roots / side, conf)
        if side == "jax":
            cfg.DATA_AUGMENTOR.AUG_CONFIG_LIST[0].DB_INFO_PATH = ["port_db.pkl"]
        np.random.seed(6)
        ds, loader = mod.build_dataloader(cfg, NAMES, batch_size=2, training=True, max_gt=64)
        assert ds.grid_size.tolist() == [1504, 1504, 40] and ds[0]["max_voxels"] == 80000
        out = []
        try:
            for epoch in range(2):
                loader.set_epoch(epoch)
                out += list(loader)
        finally:
            loader.close()
        batches[side] = out
    assert len(batches["torch"]) == len(batches["jax"]) == 6
    for g, w in zip(batches["torch"], batches["jax"]):
        assert g["frame_id"] == w["frame_id"] and g["metadata"] == w["metadata"]
        assert g["points"].shape == (2, NUM_POINTS, 5) and g["gt_boxes"].shape == (2, 64, 8)
        np.testing.assert_array_equal(g["points"], w["points"])
        np.testing.assert_array_equal(g["gt_boxes"], w["gt_boxes"])
    valid = sum(int((np.abs(b["gt_boxes"]).sum(-1) > 0).sum()) for b in batches["torch"])
    assert valid > 6 * 2 * 10  # the frames' own boxes and the pasted ones


def test_gt_database_matches_jax(roots):
    """Entry for entry and point file for point file; the port's entries
    carry the box's difficulty as the reference's do (JAX's have none)."""
    with open(roots / "jax" / DB, "rb") as f:
        want = pickle.load(f)
    with open(roots / "torch" / DB, "rb") as f:
        got = pickle.load(f)
    assert set(got) == set(want) and "unknown" not in got
    for name in want:
        assert len(got[name]) == len(want[name])
        for g, w in zip(got[name], want[name]):
            assert g["difficulty"] in (0, 2) and "difficulty" not in w
            assert_same({k: v for k, v in g.items() if k != "difficulty"}, w)
            assert filecmp.cmp(roots / "jax" / w["path"], roots / "torch" / g["path"],
                               shallow=False)


@pytest.mark.parametrize("metric", ["kitti", "waymo"])
def test_predictions_and_evaluation_match_jax(roots, metric):
    """``generate_prediction_dicts`` and ``evaluation`` with ``EVAL_METRIC``
    ``kitti`` (lidar-frame R40 AP) and ``waymo`` (AP/APH, LEVEL_1/LEVEL_2
    from the infos' difficulty and point counts): JAX's annos, text and
    numbers."""
    results = {}
    for side, mod, conf in (("jax", jwd, JConfig), ("torch", twd, Config)):
        cfg = _pv_data_cfg(roots / side, conf)
        cfg.EVAL_METRIC = metric
        ds = mod.WaymoDataset(cfg, NAMES, training=False, root_path=roots / side)
        rng = np.random.RandomState(2)
        preds = []
        for info in ds.infos:
            annos = info["annos"]
            keep = np.isin(annos["name"], NAMES)
            boxes = np.asarray(annos["gt_boxes_lidar"])[keep].copy()
            boxes[:, :2] += rng.normal(0, 0.15, (len(boxes), 2))
            labels = np.array([NAMES.index(n) + 1 for n in annos["name"][keep]])
            preds.append({"pred_boxes": boxes, "pred_labels": labels,
                          "pred_scores": np.round(rng.uniform(0.1, 1, len(boxes)), 2)})
        batch = {"frame_id": [info["frame_id"] for info in ds.infos],
                 "metadata": [info["metadata"] for info in ds.infos]}
        annos = ds.generate_prediction_dicts(batch, preds, NAMES)
        results[side] = (annos, ds.evaluation(annos, NAMES))
    assert_same(results["torch"][0], results["jax"][0])
    (got_str, got), (want_str, want) = results["torch"][1], results["jax"][1]
    assert got_str == want_str and set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-9, k
    assert max(want.values()) > 0


def test_tensorflow_gate_raises_in_both_packages(tmp_path):
    for mod in (jwd, twd):
        with pytest.raises(ImportError, match="tensorflow"):
            mod.process_single_sequence(tmp_path / "segment-1.tfrecord", tmp_path)
