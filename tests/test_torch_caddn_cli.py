"""Both CaDDN dicts through the port's ``cli/train.py`` and ``cli/test.py``
on the CPU, cut to a small size (a 256 × 800 image, 8 depth bins, a 32 × 32
× 4 grid, a narrow BEV backbone, ResNet-50 for the DeepLab DDN) on a
real-pixel tree of ``tools/synth_kitti.py``: every loss finite, the depth
loss among them, a checkpoint, and the KITTI AP table of ``cli/test.py``."""
import copy

import numpy as np
import pytest
import yaml

from modest_tpu_torch.cli import test as test_cli
from modest_tpu_torch.cli import train as train_cli
from modest_tpu_torch.configs import KITTI_CLASS_NAMES, KITTI_CONFIGS
from modest_tpu_torch.data.kitti_dataset import create_kitti_infos
from modest_tpu_torch.tools import synth_kitti
from modest_tpu_torch.utils.config import Config


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("caddn_cli")
    synth_kitti.make_dataset(root, n_train=4, n_val=2, seed=2, pixels=True, kitti_classes=True)
    create_kitti_infos(Config(KITTI_CONFIGS["CaDDN"]).DATA_CONFIG, KITTI_CLASS_NAMES, root, root)
    return root


def small_config(stem, root):
    """The shipped dict at a small size, as a YAML file."""
    cfg = copy.deepcopy(KITTI_CONFIGS[stem])
    data = cfg["DATA_CONFIG"]
    data["DATA_PATH"] = str(root)
    data["IMAGE_PAD"] = [256, 800]
    data["DATA_PROCESSOR"][1]["NUM_POINTS"] = {"train": 2048, "test": 2048}
    data["DATA_PROCESSOR"][2]["VOXEL_SIZE"] = [1.4, 1.88, 1.0]
    model = cfg["MODEL"]
    model["FFE"]["DISC_CFG"]["num_bins"] = 8
    model["BACKBONE_2D"].update(LAYER_NUMS=[1, 1, 1], NUM_FILTERS=[8, 8, 8],
                                NUM_UPSAMPLE_FILTERS=[8, 8, 8])
    if "DDN" in model["FFE"]:
        model["FFE"]["DDN"]["BACKBONE_NAME"] = "ResNet50"
    cfg["OPTIMIZATION"]["BATCH_SIZE_PER_GPU"] = 2
    path = root / f"small_{stem}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


@pytest.mark.parametrize("stem", ["CaDDN", "CaDDN_deeplab"])
def test_train_then_test(tree, tmp_path, stem):
    cfg_file = small_config(stem, tree)
    epochs = 1 if stem == "CaDDN_deeplab" else 2
    state = train_cli.main(["--cfg_file", str(cfg_file), "--epochs", str(epochs),
                            "--fix_random_seed", "--device", "cpu", "--output_dir",
                            str(tmp_path / "out"), "--set", "OPTIMIZATION.LR", "1e-4"])
    assert len(state.history) == 2 * epochs
    for rec in state.history:
        m = rec["metrics"]
        assert all(np.isfinite(v) for v in m.values()), m
        assert m["depth_loss"] > 0 and m["loss"] > m["depth_loss"]
    annos, result = test_cli.main(["--cfg_file", str(cfg_file), "--ckpt_dir",
                                   str(tmp_path / "out" / "ckpt"), "--device", "cpu",
                                   "--workers", "0", "--output_dir", str(tmp_path / "test")])
    assert [a["frame_id"] for a in annos] == ["000004", "000005"]
    assert all(np.isfinite(a["boxes_lidar"]).all() for a in annos)
    ap = [k for k in result if k.startswith(("Car_", "Pedestrian_", "Cyclist_"))]
    assert len(ap) == 48 and all(np.isfinite(result[k]) for k in ap)
    assert (tmp_path / "test" / "eval" / f"epoch_{epochs}" / "val" / "result.pkl").exists()
