"""The detector's data path in the PyTorch port against the JAX package:
KITTI infos and the gt database, the host library, the synthetic writer, and
the collated training batches under one np.random seed (augmentation off and
on). Every comparison is exact: the port's copies run the same numpy code and
the same host C++ in the same order."""
import copy
import pickle

import numpy as np
import pytest
import torch

from modest_tpu.data import kitti_dataset as jkd
from modest_tpu.data import loader as jloader
from modest_tpu.utils import native as jnative
from modest_tpu.utils.config import Config as JConfig
from modest_tpu_torch.configs import POINTRCNN_DYNAMIC_OBJ_DATA_CONFIG
from modest_tpu_torch.data import kitti_dataset as tkd
from modest_tpu_torch.data import loader as tloader
from modest_tpu_torch.ops import iou3d
from modest_tpu_torch.tools import synth_kitti as tsynth
from modest_tpu_torch.utils import native as tnative
from modest_tpu_torch.utils.config import Config

import synth_kitti
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

NUM_POINTS = 512
AUGS = ("gt_sampling", "random_world_flip", "random_world_rotation", "random_world_scaling")


def data_cfg(root, augment: bool) -> dict:
    cfg = copy.deepcopy(POINTRCNN_DYNAMIC_OBJ_DATA_CONFIG)
    cfg["DATA_PATH"] = str(root)
    cfg["DATA_PROCESSOR"][1]["NUM_POINTS"] = {"train": NUM_POINTS, "test": NUM_POINTS}
    if not augment:
        cfg["DATA_AUGMENTOR"]["DISABLE_AUG_LIST"] = list(AUGS)
    return cfg


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """One synthetic set (tests/synth_kitti.py, 6 train + 2 val frames)
    prepared by each package's create_kitti_infos in its own directory."""
    out = {}
    for side, mod in (("jax", jkd), ("torch", tkd)):
        root = tmp_path_factory.mktemp(f"kitti_{side}")
        synth_kitti.make_dataset(root, n_train=6, n_val=2, seed=5)
        cfg = data_cfg(root, True)
        mod.create_kitti_infos(JConfig(cfg) if side == "jax" else Config(cfg), ["Dynamic"],
                               root, root)
        out[side] = root
    return out


def assert_same(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


@pytest.mark.parametrize("name", ["kitti_infos_train.pkl", "kitti_infos_val.pkl",
                                  "kitti_dbinfos_train.pkl"])
def test_infos_and_gt_database_equal(roots, name):
    with open(roots["jax"] / name, "rb") as f:
        want = pickle.load(f)
    with open(roots["torch"] / name, "rb") as f:
        got = pickle.load(f)
    assert_same(got, want, name)
    if name == "kitti_dbinfos_train.pkl":
        assert sum(len(v) for v in got.values()) > 0
        for infos in got.values():
            for info in infos:
                a = np.fromfile(roots["torch"] / info["path"], np.float32)
                b = np.fromfile(roots["jax"] / info["path"], np.float32)
                np.testing.assert_array_equal(a, b)


def _batches(mod, root, augment, seed, n_epochs=2, **loader_kw):
    cfg = data_cfg(root, augment)
    cfg = JConfig(cfg) if mod is jloader else Config(cfg)
    np.random.seed(seed)
    _, loader = mod.build_dataloader(cfg, ["Dynamic"], batch_size=2, training=True,
                                     max_gt=64)
    for k, v in loader_kw.items():
        setattr(loader, k, v)
    out = []
    try:
        for epoch in range(n_epochs):
            loader.set_epoch(epoch)
            out += list(loader)
    finally:
        loader.close()
    return out


@pytest.mark.parametrize("augment", [False, True])
def test_collated_batches_equal_jax(roots, augment):
    """Under one np.random seed the port's batches are JAX's: points,
    gt_boxes (zero-padded to max_gt = 64) and frame ids, over two epochs."""
    want = _batches(jloader, roots["jax"], augment, seed=666)
    got = _batches(tloader, roots["torch"], augment, seed=666)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g["frame_id"] == w["frame_id"]
        assert g["points"].shape == (2, NUM_POINTS, 4) and g["gt_boxes"].shape == (2, 64, 8)
        np.testing.assert_array_equal(g["points"], w["points"])
        np.testing.assert_array_equal(g["gt_boxes"], w["gt_boxes"])
    if augment:  # the augmentations moved the points
        plain = _batches(tloader, roots["torch"], False, seed=666)
        assert not any(np.array_equal(g["points"], p["points"]) for g, p in zip(got, plain))


@pytest.mark.parametrize("name", ["POINTPILLAR_DYNAMIC_OBJ_FULL", "SECOND_DYNAMIC_OBJ_FULL"])
def test_grid_data_config_batches_and_geometry_equal_jax(roots, name):
    """The grid detectors' data configs (their voxel step records the grid,
    the points are sampled to a fixed count): grid_size, voxel_size and the
    recorded voxel caps equal the JAX dataset's, and so do the batches."""
    from modest_tpu_torch import configs

    full = getattr(configs, name)
    batches = {}
    for side, mod, kd, conf in (("jax", jloader, jkd, JConfig), ("torch", tloader, tkd, Config)):
        cfg = copy.deepcopy(full["DATA_CONFIG"])
        cfg["DATA_PATH"] = str(roots[side])
        cfg["DATA_PROCESSOR"][1]["NUM_POINTS"] = {"train": NUM_POINTS, "test": NUM_POINTS}
        np.random.seed(666)
        ds, loader = mod.build_dataloader(conf(cfg), ["Dynamic"], batch_size=2, training=True,
                                          max_gt=64)
        try:
            batches[side] = (ds.grid_size, ds.voxel_size, ds[0]["max_voxels"], list(loader))
        finally:
            loader.close()
    (gs, vs, cap, got), (jgs, jvs, jcap, want) = batches["torch"], batches["jax"]
    np.testing.assert_array_equal(gs, jgs)
    assert gs.dtype == jgs.dtype and vs == jvs and cap == jcap == 16000
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["points"].shape == (2, NUM_POINTS, 4)
        np.testing.assert_array_equal(g["points"], w["points"])
        np.testing.assert_array_equal(g["gt_boxes"], w["gt_boxes"])


def test_worker_processes_give_the_inline_batches(roots):
    inline = _batches(tloader, roots["torch"], True, seed=1, n_epochs=1)
    pooled = _batches(tloader, roots["torch"], True, seed=1, n_epochs=1, num_workers=2,
                      use_procs=True)
    for a, b in zip(inline, pooled):
        np.testing.assert_array_equal(a["points"], b["points"])
        np.testing.assert_array_equal(a["gt_boxes"], b["gt_boxes"])


def test_batch_to_device_on_the_cpu_keeps_the_arrays():
    batch = {"points": np.ones((2, 8, 4), np.float32), "gt_boxes": np.zeros((2, 64, 8),
                                                                           np.float32),
             "frame_id": ["a", "b"]}
    out = tloader.batch_to_device(batch, "cpu")
    assert out["frame_id"] == ["a", "b"]
    assert torch.equal(out["points"], torch.ones(2, 8, 4))
    assert out["gt_boxes"].shape == (2, 64, 8)


def _boxes(rng, n):
    return np.concatenate([rng.uniform(-10, 10, (n, 3)), rng.uniform(1, 4, (n, 3)),
                           rng.uniform(-np.pi, np.pi, (n, 1))], 1).astype(np.float32)


def test_host_library_equals_jax(tmp_path):
    """The port builds its own copy of csrc/modest_host.cpp; its ops give the
    JAX package's library's bits."""
    assert tnative.available() and jnative.available()
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 40), _boxes(rng, 30)
    np.testing.assert_array_equal(tnative.bev_iou(a, b), jnative.bev_iou(a, b))
    np.testing.assert_array_equal(tnative.bev_overlap(a, b), jnative.bev_overlap(a, b))
    pts = rng.uniform(-12, 12, (5000, 4)).astype(np.float32)
    np.testing.assert_array_equal(tnative.points_in_boxes_index(pts[:, :3], a),
                                  jnative.points_in_boxes_index(pts[:, :3], a))
    calib = synth_kitti.make_calib_obj()
    rect = np.hstack([calib.R0 @ calib.V2C[:, :3], (calib.R0 @ calib.V2C[:, 3])[:, None]])
    np.testing.assert_array_equal(tnative.fov_mask(pts, rect, calib.P2, (400, 1200)),
                                  jnative.fov_mask(pts, rect, calib.P2, (400, 1200)))
    pts.tofile(tmp_path / "scan.bin")
    np.testing.assert_array_equal(tnative.load_velo(tmp_path / "scan.bin"), pts)


def test_bev_iou_without_the_host_library_uses_the_port_op(monkeypatch):
    """Where the library cannot be built, bev_iou is ops/iou3d.py on CPU
    tensors (float32: within 1e-5 of the library's float64)."""
    rng = np.random.RandomState(1)
    a, b = _boxes(rng, 12), _boxes(rng, 9)
    native = tnative.bev_iou(a, b)
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    fallback = tnative.bev_iou(a, b)
    want = iou3d.boxes_iou_bev(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(fallback, want)
    np.testing.assert_allclose(fallback, native, atol=1e-5)


def test_synthetic_writer_equals_the_test_writer(tmp_path):
    """tools/synth_kitti.py writes the files of tests/synth_kitti.py from the
    same seed, and PNG headers of the same image size."""
    a, b = tmp_path / "tool", tmp_path / "test"
    got = tsynth.make_dataset(a, n_train=3, n_val=1, seed=7)
    want = synth_kitti.make_dataset(b, n_train=3, n_val=1, seed=7)
    for gid in want:
        np.testing.assert_array_equal(got[gid], want[gid])
    files = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    for rel in files:
        if rel.suffix == ".png":
            np.testing.assert_array_equal(tkd.png_shape(a / rel), jkd.png_shape(b / rel))
            assert (a / rel).stat().st_size < 100  # a header, no pixels
        else:
            assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel


def _tree_digest(root):
    import hashlib

    digest = hashlib.sha256()
    for path in sorted(p for p in root.rglob("*") if p.is_file()):
        digest.update(str(path.relative_to(root)).encode())
        digest.update(path.read_bytes())
    return digest.hexdigest()


@pytest.mark.parametrize("kwargs,want", [
    ({"n_train": 2, "n_val": 1, "seed": 7},
     "a87212a374c763caccfa2d362c11e7c96483d0431fef4b8c3dd6169f80162627"),
    ({"n_train": 2, "n_val": 1, "seed": 0, "full_density": True},
     "b8cfb64c312c0040f86fa0537029a43e740018b11f9b812c0a3ee6329327db43"),
])
def test_synthetic_writer_default_output_is_unchanged(tmp_path, kwargs, want):
    """Without ``kitti_classes`` every file is byte for byte what the writer
    gave before the option existed (the digests of its files then)."""
    tsynth.make_dataset(tmp_path, **kwargs)
    assert _tree_digest(tmp_path) == want


def test_synthetic_writer_kitti_classes(tmp_path):
    """``kitti_classes``: Car, Pedestrian and Cyclist objects at KITTI's
    sizes (±10 %) inside KITTI's range, read back by the port's KITTI
    label reader."""
    from modest_tpu_torch.utils import kitti_io

    boxes = tsynth.make_dataset(tmp_path, n_train=3, n_val=0, seed=0, full_density=True,
                                kitti_classes=True)
    names = []
    for gid, b in boxes.items():
        objs = kitti_io.read_label(
            tmp_path / "training" / "label_2" / f"{gid:06d}.txt")
        assert len(objs) == len(b) >= 8
        for obj, box in zip(objs, b):
            names.append(obj.cls_type)
            size = np.asarray(tsynth.KITTI_SIZES[obj.cls_type])
            assert np.all(np.abs(box[3:6] / size - 1) <= 0.1 + 1e-9)
            assert 0 < box[0] < 70.4 and -40 < box[1] < 40 and -3 < box[2] < 1
    assert set(names) == {"Car", "Pedestrian", "Cyclist"}


def test_full_density_scenes(tmp_path):
    boxes = tsynth.make_dataset(tmp_path, n_train=2, n_val=0, seed=0, full_density=True)
    for gid, b in boxes.items():
        assert 8 <= len(b) <= 20
        n = len(np.fromfile(tmp_path / "training" / "velodyne" / f"{gid:06d}.bin",
                            np.float32)) // 4
        assert 60_000 <= n <= 90_000
