"""CaDDN's data path in the PyTorch port against the JAX package on the CPU:
the PNG reader against PIL, the synthetic tree with real pixels, the KITTI
camera items (images, depth maps, calibration matrices, 2D boxes) with the
depth-map downsample and the image flip under one ``np.random`` seed, the
collated batch, ``model_inputs`` and ``build_dataloader`` on the shipped
CaDDN dict."""
import copy
import filecmp
import os
import pickle
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from modest_tpu.data import kitti_dataset as jkd
from modest_tpu.data import loader as jloader
from modest_tpu.train import loop as jloop
from modest_tpu.utils.config import Config as JConfig
from modest_tpu_torch.configs import KITTI_CLASS_NAMES, KITTI_CONFIGS
from modest_tpu_torch.data import kitti_dataset as kd
from modest_tpu_torch.data import loader
from modest_tpu_torch.data.augmentor import random_image_flip_horizontal
from modest_tpu_torch.data.processor import downsample_depth_map
from modest_tpu_torch.tools import synth_kitti as port_synth
from modest_tpu_torch.train.loop import model_inputs
from modest_tpu_torch.utils import native, png
from modest_tpu_torch.utils.config import Config

import synth_kitti
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

def _filter_rows(pix: np.ndarray, filters) -> bytes:
    """The raw IDAT stream of (H, W, C) uint8 ``pix`` with row y filtered by
    ``filters[y % len(filters)]`` (PNG spec §9)."""
    h, w, c = pix.shape
    rows = pix.reshape(h, w * c).astype(np.int64)
    out = []
    for y in range(h):
        ft = filters[y % len(filters)]
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        if ft == 0:
            pred = 0
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = up
        elif ft == 3:
            pred = (left + up) >> 1
        else:
            p = left + up - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        out.append(bytes([ft]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
    return b"".join(out)


def _write_filtered(path, pix, colour, filters):
    h, w = pix.shape[:2]
    ihdr = np.array([w, h], ">u4").tobytes() + bytes([8, colour, 0, 0, 0])
    with open(path, "wb") as f:
        f.write(png.SIGNATURE + png.chunk(b"IHDR", ihdr)
                + png.chunk(b"IDAT", zlib.compress(_filter_rows(pix, filters)))
                + png.chunk(b"IEND", b""))


def _noise(seed, h=37, w=53):
    """Noise over a gradient, so PIL's per-row filter choice varies."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    smooth = np.stack([3 * xx, 5 * yy, xx + 2 * yy], -1) % 256
    return np.where((yy // 4 % 2 == 0)[..., None], smooth, rng.randint(0, 256, (h, w, 3))
                    ).astype(np.uint8)


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA", "LA", "P"])
def test_png_reader_equals_pil_on_pil_files(tmp_path, mode):
    img = _noise(0)
    pil = {"RGB": Image.fromarray(img), "L": Image.fromarray(img[..., 0]),
           "RGBA": Image.fromarray(np.concatenate([img, img[..., :1]], -1)),
           "LA": Image.fromarray(img[..., :2], "LA"), "P": Image.fromarray(img).convert("P")}[mode]
    path = tmp_path / f"{mode}.png"
    pil.save(path)
    np.testing.assert_array_equal(png.read_png_rgb(path),
                                  np.asarray(Image.open(path).convert("RGB")))


@pytest.mark.parametrize("colour,channels", [(2, 3), (6, 4), (0, 1), (4, 2)])
def test_png_reader_undoes_every_filter(tmp_path, colour, channels):
    """Rows filtered None, Sub, Up, Average and Paeth in turn (PIL writes no
    Average rows): the host library, its numpy twin and PIL agree."""
    pix = np.concatenate([_noise(1), _noise(2)[..., :1]], -1)[..., :channels]
    path = tmp_path / "filtered.png"
    _write_filtered(path, pix, colour, (0, 1, 2, 3, 4, 4, 3, 1))
    want = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(png.read_png_rgb(path), want)
    idat = b"".join(body for kind, body in png._chunks(path.read_bytes()) if kind == b"IDAT")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    h, w = pix.shape[:2]
    fallback = png.unfilter_rows(raw, h, w * channels, channels)
    assert native.available()
    np.testing.assert_array_equal(native.png_unfilter(raw, h, w * channels, channels), fallback)
    np.testing.assert_array_equal(fallback.reshape(pix.shape), pix)


def test_png_writer_round_trip(tmp_path):
    img = _noise(3, 40, 61)
    png.write_png(tmp_path / "w.png", img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "w.png")), img)
    np.testing.assert_array_equal(png.read_png_rgb(tmp_path / "w.png"), img)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The port's tree with pixels and tests/synth_kitti.py's at one seed,
    3-class labels, the port's infos in the first."""
    port_root = tmp_path_factory.mktemp("caddn_port_tree")
    jax_root = tmp_path_factory.mktemp("caddn_jax_tree")
    port_synth.make_dataset(port_root, n_train=4, n_val=2, seed=5, pixels=True)
    synth_kitti.make_dataset(jax_root, n_train=4, n_val=2, seed=5)
    port_synth.make_dataset(port_root / "classes", n_train=4, n_val=2, seed=5, pixels=True,
                            kitti_classes=True)
    root = port_root / "classes"
    cfg = Config(copy.deepcopy(KITTI_CONFIGS["CaDDN"]["DATA_CONFIG"]))
    kd.create_kitti_infos(cfg, KITTI_CLASS_NAMES, root, root)
    return port_root, jax_root, root


def test_pixel_tree_equals_the_jax_tests_tree_but_pixels(trees):
    port_root, jax_root, _ = trees
    for sub in ("velodyne", "calib", "label_2", "planes"):
        names = sorted(os.listdir(jax_root / "training" / sub))
        assert names == sorted(os.listdir(port_root / "training" / sub))
        _, mismatch, errors = filecmp.cmpfiles(jax_root / "training" / sub,
                                               port_root / "training" / sub, names, shallow=False)
        assert not mismatch and not errors, (sub, mismatch)
    for name in ("train.txt", "val.txt"):
        assert filecmp.cmp(jax_root / "ImageSets" / name, port_root / "ImageSets" / name, False)
    img = Image.open(port_root / "training" / "image_2" / "000000.png").convert("RGB")
    assert img.size == (port_synth.IMG_SHAPE[1], port_synth.IMG_SHAPE[0])
    pix = png.read_png_rgb(port_root / "training" / "image_2" / "000000.png")
    np.testing.assert_array_equal(pix, np.asarray(img))
    assert (pix == port_synth.BOX_COLOURS["Dynamic"]).all(-1).sum() > 100  # a painted box


def _datasets(root, training, **changes):
    data = copy.deepcopy(KITTI_CONFIGS["CaDDN"]["DATA_CONFIG"])
    data.update(changes)
    return (jkd.KittiDataset(JConfig(copy.deepcopy(data)), KITTI_CLASS_NAMES, training=training,
                             root_path=root),
            kd.KittiDataset(Config(data), KITTI_CLASS_NAMES, training=training, root_path=root))


def _assert_same(want, got):
    assert set(want) == set(got)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        elif key != "calib":
            np.testing.assert_equal(got[key], value, err_msg=key)


@pytest.mark.parametrize("training", [True, False])
def test_camera_items_equal_jax(trees, training):
    """Every item of every frame under one ``np.random`` seed, train (the
    image flip, which flips some frames and not others) and test."""
    root = trees[2]
    jds, ds = _datasets(root, training)
    flipped = 0
    for i in range(len(ds)):
        np.random.seed(100 + i)
        want = jds[i]
        np.random.seed(100 + i)
        got = ds[i]
        _assert_same(want, got)
        assert got["images"].shape == (384, 1248, 3) and got["depth_maps"].shape == (96, 312)
        assert (got["depth_maps"] > 0).sum() > 200
        if training:
            img = png.read_png_rgb(root / "training" / "image_2" / f"{got['frame_id']}.png")
            flipped += not np.array_equal(got["images"][:4, :100],
                                          img[:4, :100].astype(np.float32) / 255.0)
    assert not training or 0 < flipped < len(ds)


def test_downsample_depth_map_equals_jax():
    from modest_tpu.data.processor import DataProcessor as JProcessor

    rng = np.random.RandomState(0)
    dm = rng.uniform(0, 50, (38, 61)).astype(np.float32)
    dm[rng.rand(38, 61) < 0.8] = 0.0
    step = [JConfig({"NAME": "downsample_depth_map", "DOWNSAMPLE_FACTOR": 4})]
    want = JProcessor(step, [0, -1, -1, 1, 1, 1], training=False)({"depth_maps": dm})
    got = downsample_depth_map(dm, 4)
    assert got.shape == (9, 15) and got.dtype == want["depth_maps"].dtype
    np.testing.assert_array_equal(got, want["depth_maps"])


def test_random_image_flip_equals_jax():
    from modest_tpu.data.augmentor import random_image_flip_horizontal as jflip

    calib = port_synth.make_calib_obj()
    rng = np.random.RandomState(1)
    image = rng.rand(20, 30, 3).astype(np.float32)
    depth = rng.rand(20, 30).astype(np.float32)
    boxes = np.array([[10.0, 2.0, -1.0, 4.0, 1.8, 1.5, 0.3, 1.0]], np.float32)
    boxes2d = np.array([[3.0, 4.0, 12.0, 15.0]], np.float32)
    outcomes = set()
    for seed in range(6):
        np.random.seed(seed)
        want = jflip(image, depth, boxes, calib, boxes2d)
        want_next = np.random.rand()
        np.random.seed(seed)
        got = random_image_flip_horizontal(image, depth, boxes, calib, boxes2d)
        assert np.random.rand() == want_next  # the same draws taken
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
        outcomes.add(got[0] is image)
    assert outcomes == {True, False}


def test_collate_and_model_inputs_equal_jax(trees):
    root = trees[2]
    jds, ds = _datasets(root, True)
    np.random.seed(7)
    want = jloader.collate_batch([jds[0], jds[1]], max_gt=8)
    np.random.seed(7)
    got = loader.collate_batch([ds[0], ds[1]], max_gt=8)
    _assert_same({k: v for k, v in want.items() if k != "calib"},
                 {k: v for k, v in got.items() if k != "calib"})
    assert got["gt_boxes2d"].shape == (2, 8, 4) and got["images"].shape == (2, 384, 1248, 3)
    cfg = Config(KITTI_CONFIGS["CaDDN"]["MODEL"])
    for eval_mode in (False, True):
        jin = jloop.model_inputs(want, JConfig(cfg.to_dict()), eval_mode=eval_mode)
        tin = model_inputs(loader.batch_to_device(got, "cpu"), cfg, eval_mode=eval_mode)
        assert list(jin) == list(tin)
        for key in jin:
            np.testing.assert_array_equal(tin[key].numpy(), np.asarray(jin[key]))
    assert torch.equal(model_inputs(loader.batch_to_device(got, "cpu"),
                                    Config(KITTI_CONFIGS["second"]["MODEL"])),
                       torch.from_numpy(got["points"]))


def test_build_dataloader_on_the_caddn_dict(trees):
    root = trees[2]
    cfg = Config(copy.deepcopy(KITTI_CONFIGS["CaDDN"]))
    np.random.seed(0)
    dataset, dl = loader.build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 2, root_path=root)
    assert tuple(dataset.grid_size) == (280, 376, 25)
    batch = loader.batch_to_device(next(iter(dl)), "cpu")
    shapes = {k: tuple(batch[k].shape) for k in loader.CAMERA_KEYS}
    assert shapes == {"images": (2, 384, 1248, 3), "depth_maps": (2, 96, 312),
                      "trans_lidar_to_cam": (2, 4, 4), "trans_cam_to_img": (2, 3, 4),
                      "gt_boxes2d": (2, 64, 4)}
    assert batch["points"].shape == (2, 16384, 4)
    assert (batch["gt_boxes"].abs().sum(-1) > 0).sum() > 0


def test_unknown_item_raises(trees):
    data = copy.deepcopy(KITTI_CONFIGS["CaDDN"]["DATA_CONFIG"])
    data["GET_ITEM_LIST"] = ["points", "semantic_maps"]
    with pytest.raises(ValueError, match="semantic_maps"):
        kd.KittiDataset(Config(data), KITTI_CLASS_NAMES, training=False, root_path=trees[2])


def test_infos_carry_the_pixel_trees_shape(trees):
    with open(trees[2] / "kitti_infos_train.pkl", "rb") as f:
        infos = pickle.load(f)
    np.testing.assert_array_equal(infos[0]["image"]["image_shape"], port_synth.IMG_SHAPE)
