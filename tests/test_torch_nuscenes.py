"""The port's nuScenes data layer (``data/nuscenes_dataset.py``,
``data/nuscenes_writer.py``, ``tools/synth_infos.py``) against the JAX
package's, on the same seeded trees: items under one ``np.random`` seed
with the velocity on and off (points, gt boxes, and the voxels both
packages' voxelizers make of them), the CBGS config's training batches
(balanced resampling, gt sampling, the world augmentations), the gt
database, predictions and the SDK-free evaluation, the info writer and
the submission writer on a stub devkit handle, and the devkit gate."""
from __future__ import annotations

import copy
import filecmp
import pickle
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modest_tpu.data import loader as jloader
from modest_tpu.data import nuscenes_dataset as jnd
from modest_tpu.data import nuscenes_writer as jnw
from modest_tpu.models import voxelize as jvox
from modest_tpu.utils.config import Config as JConfig
from modest_tpu_torch import configs
from modest_tpu_torch.data import loader as tloader
from modest_tpu_torch.data import nuscenes_dataset as tnd
from modest_tpu_torch.data import nuscenes_writer as tnw
from modest_tpu_torch.models import voxelize as tvox
from modest_tpu_torch.tools import synth_infos
from modest_tpu_torch.utils.config import Config
from tests.test_nuscenes_waymo import NUSC_CFG, make_nusc_tree
from tests.test_torch_data import assert_same
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

NAMES = ["car", "pedestrian"]
FULL_POINTS = 3000  # a sweep of the small full-density tree
NUM_POINTS = 4096


def trees_equal(a, b):
    """Same files; pkls equal as loaded, the rest byte for byte."""
    fa = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    fb = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert fa == fb
    for f in fa:
        if f.suffix == ".pkl":
            with open(a / f, "rb") as fh_a, open(b / f, "rb") as fh_b:
                assert_same(pickle.load(fh_a), pickle.load(fh_b), str(f))
        else:
            assert filecmp.cmp(a / f, b / f, shallow=False), f
    return len(fa)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The tiny tree and a small full-density tree (4 train, 2 val frames),
    each twice: one copy for each package's gt database."""
    base = tmp_path_factory.mktemp("nusc")
    synth_infos.write_nuscenes_tree(base / "tiny", rng=np.random.RandomState(0))
    synth_infos.write_nuscenes_tree(base / "jax", 4, rng=np.random.RandomState(1),
                                    full_density=True, n_val=2, points=FULL_POINTS)
    shutil.copytree(base / "jax", base / "torch")
    info = "nuscenes_infos_train_10sweeps_withvelo.pkl"
    for side, mod in (("jax", jnd), ("torch", tnd)):
        conf = JConfig if side == "jax" else Config
        cfg = conf({**configs.NUSCENES_DATASET_BASE, "INFO_PATH": {"train": [info],
                                                                   "test": [info]}})
        cfg.pop("VERSION")
        np.random.seed(7)
        ds = mod.NuScenesDataset(cfg, configs.CBGS_CLASS_NAMES, training=False,
                                 root_path=base / side)
        ds.create_groundtruth_database(max_sweeps=10)
    return base


def test_tiny_tree_is_make_nusc_tree(tmp_path):
    make_nusc_tree(tmp_path / "a", n_frames=4, n_sweeps=3, rng=np.random.RandomState(5))
    synth_infos.write_nuscenes_tree(tmp_path / "b", n_frames=4, n_sweeps=3,
                                    rng=np.random.RandomState(5))
    assert trees_equal(tmp_path / "a", tmp_path / "b") == 1 + 4 * 4


def _voxels(points, side):
    """(coords, valid, feats) of one scan at the CBGS SECOND geometry."""
    vs, gs = configs.CBGS_GEOMETRY["cbgs_second_multihead"]
    pcr = configs.CBGS_POINT_CLOUD_RANGE
    nx, ny, nz = gs
    if side == "jax":
        p = jnp.asarray(points)
        c, v = jvox.point_voxel_coords(p, pcr, vs, gs)
        out = jvox.voxelize_sparse(p, v, c, 2048, nx, ny, nz)
        return [np.asarray(x) for x in (out[0], out[2], out[1])]
    p = torch.from_numpy(points)[None]
    c, v = tvox.point_voxel_coords(p, pcr, vs, gs)
    out = tvox.voxelize_sparse(p, v, c, 2048, nx, ny, nz)
    return [x[0].numpy() for x in (out[0], out[2], out[1])]


@pytest.mark.parametrize("pred_velocity", [False, True])
def test_items_match_jax(roots, pred_velocity):
    """Three training items of the tiny tree (3 sweeps each, the ego points
    dropped, the time lag as the 5th feature): points and gt boxes equal,
    gt of width 10 with the velocity and 8 without; the voxels both
    packages make of the points equal, their mean features within 1e-6."""
    cfg = dict(NUSC_CFG, PRED_VELOCITY=pred_velocity)
    items = {}
    for side, mod, conf in (("jax", jnd, JConfig), ("torch", tnd, Config)):
        np.random.seed(3)
        ds = mod.NuScenesDataset(conf(cfg), NAMES, training=True, root_path=roots / "tiny")
        items[side] = [ds[i] for i in range(len(ds))]
    assert_same(items["torch"], items["jax"])
    for item in items["torch"]:
        assert item["points"].shape == (1024, 5) and (item["points"][:, 4] != 0).any()
        assert item["gt_boxes"].shape[1] == (10 if pred_velocity else 8)
        got, want = _voxels(item["points"], "torch"), _voxels(item["points"], "jax")
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[2], want[2], rtol=1e-6, atol=1e-6)
        assert got[1].sum() > 50


def _cbgs_cfg(root, conf, **changes):
    cfg = copy.deepcopy(configs.CBGS_CONFIGS["cbgs_second_multihead"]["DATA_CONFIG"])
    cfg.pop("VERSION")
    cfg["DATA_PATH"] = str(root)
    cfg["DATA_PROCESSOR"][2]["NUM_POINTS"] = {"train": NUM_POINTS, "test": NUM_POINTS}
    cfg.update(changes)
    return conf(cfg)


def test_balanced_resampling_matches_jax(roots):
    """CBGS resampling draws the same frames in the same order (the tiny
    tree's six frames, as tests/test_nuscenes_waymo.py, and the full tree
    with its ten classes)."""
    make_nusc_tree(roots / "six", n_frames=6, rng=np.random.RandomState(0))
    for root, names, cfg in (
            (roots / "six", NAMES, dict(NUSC_CFG, BALANCED_RESAMPLING=True)),
            (roots / "torch", configs.CBGS_CLASS_NAMES, None)):
        tokens = {}
        for side, mod, conf in (("jax", jnd, JConfig), ("torch", tnd, Config)):
            np.random.seed(11)
            c = conf(cfg) if cfg is not None else _cbgs_cfg(root, conf, DATA_AUGMENTOR=None)
            ds = mod.NuScenesDataset(c, names, training=True, root_path=root)
            tokens[side] = [info["token"] for info in ds.infos]
        assert tokens["torch"] == tokens["jax"]
        assert len(tokens["torch"]) > 0


def test_gt_database_matches_jax(roots):
    name = "nuscenes_dbinfos_10sweeps_withvelo.pkl"
    with open(roots / "jax" / name, "rb") as f:
        want = pickle.load(f)
    with open(roots / "torch" / name, "rb") as f:
        got = pickle.load(f)
    assert_same(got, want)
    assert len(got) >= 5 and all(info["box3d_lidar"].shape == (9,)
                                 for infos in got.values() for info in infos)
    for infos in got.values():
        for info in infos:
            assert filecmp.cmp(roots / "jax" / info["path"], roots / "torch" / info["path"],
                               shallow=False)


def test_cbgs_training_batches_match_jax(roots):
    """The shipped CBGS data config (balanced resampling, gt sampling from
    each package's own database, flips on x and y, rotation, scaling), at
    4096 points a scan: two epochs of batches equal JAX's, gt of width 10."""
    batches = {}
    for side, mod, conf in (("jax", jloader, JConfig), ("torch", tloader, Config)):
        np.random.seed(5)
        _, loader = mod.build_dataloader(_cbgs_cfg(roots / side, conf), configs.CBGS_CLASS_NAMES,
                                         batch_size=2, training=True, max_gt=64)
        out = []
        try:
            for epoch in range(2):
                loader.set_epoch(epoch)
                out += list(loader)
        finally:
            loader.close()
        batches[side] = out
    assert len(batches["torch"]) == len(batches["jax"]) > 2
    for g, w in zip(batches["torch"], batches["jax"]):
        assert g["frame_id"] == w["frame_id"] and g["metadata"] == w["metadata"]
        assert g["points"].shape == (2, NUM_POINTS, 5) and g["gt_boxes"].shape == (2, 64, 10)
        np.testing.assert_array_equal(g["points"], w["points"])
        np.testing.assert_array_equal(g["gt_boxes"], w["gt_boxes"])
    gt = np.concatenate([b["gt_boxes"].reshape(-1, 10) for b in batches["torch"]])
    gt = gt[np.abs(gt).sum(1) > 0]
    assert np.isfinite(gt).all() and (gt[:, 7:9] != 0).any()  # NaN velocities set to 0
    assert set(np.unique(gt[:, 9])) <= set(range(1, 11)) and len(np.unique(gt[:, 9])) > 3


def _predictions(ds, rng):
    """Per frame: the gt boxes jittered, a false positive, 9-column boxes."""
    preds = []
    for info in ds.infos:
        boxes = np.nan_to_num(np.asarray(info["gt_boxes"], np.float32)).copy()
        boxes[:, :3] += rng.normal(0, 0.3, (len(boxes), 3))
        boxes = np.concatenate([boxes, [[5, 5, -1, 4, 2, 1.6, 0, 0, 0]]]).astype(np.float32)
        labels = np.array([ds.class_names.index(n) + 1 for n in info["gt_names"]] + [1])
        preds.append({"pred_boxes": boxes, "pred_scores": rng.uniform(0.1, 1, len(boxes)),
                      "pred_labels": labels})
    return preds


def test_predictions_and_evaluation_match_jax(roots):
    """``generate_prediction_dicts`` and the SDK-free ``evaluation`` (NDS
    terms and the BEV AP table) give JAX's annos, text and numbers."""
    results = {}
    for side, mod, conf in (("jax", jnd, JConfig), ("torch", tnd, Config)):
        ds = mod.NuScenesDataset(_cbgs_cfg(roots / side, conf), configs.CBGS_CLASS_NAMES,
                                 training=False, root_path=roots / side)
        preds = _predictions(ds, np.random.RandomState(2))
        batch = {"frame_id": [f"f{i}" for i in range(len(preds))],
                 "metadata": [{"token": info["token"]} for info in ds.infos]}
        annos = ds.generate_prediction_dicts(batch, preds, ds.class_names)
        results[side] = (annos, ds.evaluation(annos, ds.class_names))
    assert_same(results["torch"][0], results["jax"][0])
    (got_str, got), (want_str, want) = results["torch"][1], results["jax"][1]
    assert got_str == want_str and set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-9, k
    assert want["mAP"] > 0 and "NDS" in want


class StubNusc:
    """The devkit handle's tables and calls that the writer uses, for one
    scene of three samples with sweeps between them, from a seed."""

    def __init__(self, root, seed=0):
        rng = np.random.RandomState(seed)
        self.dataroot = str(root)
        self.tables = {"sample_data": {}, "calibrated_sensor": {}, "ego_pose": {},
                       "sample_annotation": {}, "sample": {}}
        self.velocity = {}

        def quat(yaw):
            return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]

        self.tables["calibrated_sensor"]["cs"] = {"translation": [0.9, 0.0, 1.8],
                                                  "rotation": quat(0.01)}
        self.scene = [{"name": "scene-0001", "token": "sc1"}, {"name": "scene-0002",
                                                               "token": "sc2"}]
        prev, sample_tokens = "", []
        for k in range(7):  # 20 Hz sweeps; every third one a keyframe
            token = f"sd{k}"
            self.tables["ego_pose"][f"ep{k}"] = {
                "translation": [100 + 0.5 * k, 50 + 0.1 * k, 0.0], "rotation": quat(0.3 + 0.01 * k)}
            self.tables["sample_data"][token] = {
                "token": token, "calibrated_sensor_token": "cs", "ego_pose_token": f"ep{k}",
                "timestamp": 1_500_000_000_000_000 + 50_000 * k, "prev": prev,
                "filename": f"sweeps/LIDAR_TOP/{token}.pcd.bin"}
            prev = token
            if k % 3 == 0:
                anns = []
                for a in range(3):
                    at = f"ann{k}_{a}"
                    anns.append(at)
                    self.tables["sample_annotation"][at] = {
                        "token": at, "translation": list(rng.uniform(80, 120, 3)),
                        "size": list(rng.uniform(0.5, 5, 3)),
                        "rotation": quat(rng.uniform(-np.pi, np.pi)),
                        "num_lidar_pts": int(rng.randint(0, 3)),
                        "num_radar_pts": int(rng.randint(0, 2)),
                        "category_name": ["vehicle.car", "human.pedestrian.adult",
                                          "animal"][a]}
                    self.velocity[at] = (rng.uniform(-3, 3, 3) if a != 1
                                         else np.array([np.nan] * 3))
                st = f"s{k}"
                sample_tokens.append(st)
                self.tables["sample"][st] = {"token": st, "data": {"LIDAR_TOP": token},
                                             "anns": anns,
                                             "scene_token": "sc1" if k < 6 else "sc2"}
        self.sample = [self.tables["sample"][t] for t in sample_tokens]

    def get(self, table, token):
        return self.tables[table][token]

    def get_sample_data_path(self, token):
        return f"{self.dataroot}/{self.tables['sample_data'][token]['filename']}"

    def box_velocity(self, token):
        return self.velocity[token]


def test_writers_match_jax_on_a_stub_devkit(tmp_path):
    """``fill_trainval_infos`` (sweeps walked back, transforms, lidar-frame
    boxes and velocities, the category map) and
    ``transform_det_annos_to_nusc_annos`` (global boxes, attributes) give
    JAX's output on one stub handle; ``quaternion_yaw`` too."""
    nusc = StubNusc(tmp_path)
    want = jnw.fill_trainval_infos(nusc, ["scene-0001"], ["scene-0002"], max_sweeps=4)
    got = tnw.fill_trainval_infos(nusc, ["scene-0001"], ["scene-0002"], max_sweeps=4)
    assert_same(got, want)
    assert [len(x) for x in got] == [2, 1] and len(got[0][1]["sweeps"]) == 3
    assert got[0][0]["sweeps"][0]["transform_matrix"] is None  # no earlier sweep
    rng = np.random.RandomState(4)
    det_annos = [{"metadata": {"token": s["token"]},
                  "boxes_lidar": rng.uniform(-5, 5, (4, 9)).astype(np.float32),
                  "name": np.asarray(["car", "pedestrian", "bus", "bicycle"]),
                  "score": rng.uniform(0, 1, 4)} for s in nusc.sample]
    want = jnw.transform_det_annos_to_nusc_annos(copy.deepcopy(det_annos), nusc)
    got = tnw.transform_det_annos_to_nusc_annos(copy.deepcopy(det_annos), nusc)
    assert got == want and len(got["results"]) == 3
    for q in ([1, 0, 0, 0], [0.7, 0.1, -0.2, 0.68]):
        assert tnw.quaternion_yaw(q) == jnw.quaternion_yaw(q)


def test_devkit_gate_raises_in_both_packages(tmp_path):
    """Without the nuscenes devkit, building infos from a raw tree raises
    ImportError in both packages, and the evaluation takes its SDK-free
    route (``test_predictions_and_evaluation_match_jax``)."""
    for mod in (jnd, tnd):
        with pytest.raises(ImportError, match="nuscenes devkit"):
            mod.create_nuscenes_infos("v1.0-mini", tmp_path, tmp_path)
