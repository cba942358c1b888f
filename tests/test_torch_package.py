"""Rules of the PyTorch port package: it never imports JAX or the JAX
package (nor PyYAML, tqdm, sklearn, PIL or tensorboard, which the card's
machine lacks), it
runs on the card unless the caller asks for the CPU, it ships the flagship
config as a dict equal to the YAML, and its state-dict keys are pcdet's."""
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from modest_tpu.utils.config import cfg_from_yaml_file as j_cfg_from_yaml_file
from modest_tpu_torch.configs import (POINTRCNN_DYNAMIC_OBJ, POINTRCNN_DYNAMIC_OBJ_CLASS_NAMES,
                                      POINTRCNN_DYNAMIC_OBJ_NUM_POINTS)
from modest_tpu_torch.models import build_network
from modest_tpu_torch.utils.config import Config, cfg_from_yaml_file

REPO = Path(__file__).resolve().parents[1]
FLAGSHIP_YAML = REPO / "configs/models/lyft_models/pointrcnn_dynamic_obj.yaml"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|modest_tpu)\b(?!_torch)",
                       re.MULTILINE)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in [*(REPO / "modest_tpu_torch").rglob("*.py"),
                                      REPO / "chip_smoke.py"]))
def test_port_never_imports_jax_or_the_jax_package(path):
    src = (REPO / path).read_text()
    assert not FORBIDDEN.findall(src), f"{path} imports {FORBIDDEN.findall(src)}"


THIRD_PARTY = re.compile(r"^\s*(?:import|from)\s+(yaml|tqdm|sklearn|PIL|tensorboard|tensorboardX)\b",
                         re.MULTILINE)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in [*(REPO / "modest_tpu_torch").rglob("*.py"),
                                      REPO / "chip_smoke.py"]))
def test_port_never_imports_yaml_tqdm_or_sklearn(path):
    """The card's machine has none of them (nor PIL or tensorboard;
    ``train/metrics.py`` reaches TensorBoard only through a guarded
    ``torch.utils.tensorboard``). The one exception is the lazy
    ``import yaml`` inside ``utils/config.py::_load_yaml``, which only
    ``cfg_from_yaml_file`` reaches."""
    src = (REPO / path).read_text()
    found = THIRD_PARTY.findall(src)
    if path == "modest_tpu_torch/utils/config.py":
        lazy = re.findall(r"def _load_yaml\(.*\):\n    import yaml\b", src)
        assert found == ["yaml"] and len(lazy) == 1, found
        return
    assert not found, f"{path} imports {found}"


def test_flagship_dict_equals_the_yaml():
    cfg = cfg_from_yaml_file(FLAGSHIP_YAML)
    assert cfg.MODEL.to_dict() == POINTRCNN_DYNAMIC_OBJ
    assert list(cfg.CLASS_NAMES) == POINTRCNN_DYNAMIC_OBJ_CLASS_NAMES
    assert cfg.DATA_CONFIG.DATA_PROCESSOR[1].NUM_POINTS.test == POINTRCNN_DYNAMIC_OBJ_NUM_POINTS
    # and the JAX package's loader reads the same file the same way
    assert j_cfg_from_yaml_file(str(FLAGSHIP_YAML)).MODEL.to_dict() == POINTRCNN_DYNAMIC_OBJ


def test_build_network_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the refusal needs a host without one")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_network(Config(POINTRCNN_DYNAMIC_OBJ), 1)
    model = build_network(Config(POINTRCNN_DYNAMIC_OBJ), 1, device="cpu")
    assert not model.training
    assert {p.device.type for p in model.parameters()} == {"cpu"}


@pytest.mark.parametrize("name,backbone", [("SECONDNet", "VoxelResBackBone8x"),
                                           ("PointRCNN", "UNetV2")])
def test_build_network_refuses_unported_detectors(name, backbone):
    """Once refused, both build now: SECOND with the residual sparse
    backbone (nuScenes CBGS) and the sparse-UNet PointRCNN (PartA2Free, from
    KITTI's PartA2_free dict). Another sparse backbone is still refused."""
    import copy
    import types

    from modest_tpu_torch.configs import KITTI_PART_A2_FREE, SECOND_DYNAMIC_OBJ
    from modest_tpu_torch.models.part_a2 import PartA2Free
    from modest_tpu_torch.models.sparse_conv import VoxelResBackBone8x

    cfg = Config(copy.deepcopy(SECOND_DYNAMIC_OBJ if name == "SECONDNet" else KITTI_PART_A2_FREE))
    cfg.NAME = name
    cfg.BACKBONE_3D.NAME = backbone
    geometry = types.SimpleNamespace(point_cloud_range=[0, -40, -3, 90.4, 40, 1],
                                     voxel_size=[0.05, 0.05, 0.1], grid_size=[1808, 1600, 40])
    model = build_network(cfg, 1 if name == "SECONDNet" else 3, device="cpu", dataset=geometry)
    assert isinstance(model.backbone_3d if name == "SECONDNet" else model,
                      VoxelResBackBone8x if name == "SECONDNet" else PartA2Free)
    cfg.BACKBONE_3D.NAME = "SparseResNet"
    with pytest.raises(NotImplementedError):
        build_network(cfg, 1, device="cpu", dataset=geometry)


@pytest.mark.parametrize("dataset", ["nuscenes", "waymo"])
def test_build_dataloader_takes_nuscenes_and_waymo(dataset, tmp_path):
    """``build_dataloader`` builds both datasets from the shipped dicts (it
    refused them before they were ported), their batches carry the frames'
    metadata and 5-feature points, and ``build_network`` on such a dataset
    still refuses to run without a card unless asked for the CPU."""
    import copy

    import numpy as np

    from modest_tpu_torch import configs
    from modest_tpu_torch.data.loader import build_dataloader
    from modest_tpu_torch.data.nuscenes_dataset import NuScenesDataset
    from modest_tpu_torch.data.waymo_dataset import WaymoDataset
    from modest_tpu_torch.tools import synth_infos

    rng = np.random.RandomState(0)
    if dataset == "nuscenes":
        full = copy.deepcopy(configs.CBGS_CONFIGS["cbgs_pp_multihead"])
        synth_infos.write_nuscenes_tree(tmp_path / full["DATA_CONFIG"]["VERSION"], 2, rng=rng,
                                        full_density=True, n_val=2, points=2000)
        cls = NuScenesDataset
    else:
        full = copy.deepcopy(configs.WAYMO_CONFIGS["second"])
        synth_infos.write_waymo_tree(tmp_path, 2, rng=rng, full_density=True, n_val=2,
                                     points=2000)
        full["DATA_CONFIG"]["SAMPLED_INTERVAL"]["test"] = 1
        cls = WaymoDataset
    cfg = Config(full)
    cfg.DATA_CONFIG.DATA_PATH = str(tmp_path)
    ds, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 2, training=False)
    assert isinstance(ds, cls) and len(ds) == 2
    batch = next(iter(loader))
    assert batch["points"].shape[-1] == 5 and len(batch["metadata"]) == 2
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the refusal needs a host without one")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset=ds)


def test_forward_refuses_train_mode():
    """Train mode needs gt boxes: without them the forward refuses and
    points to eval mode."""
    model = build_network(Config(POINTRCNN_DYNAMIC_OBJ), 1, device="cpu").train()
    with pytest.raises(ValueError, match="eval"):
        model(torch.zeros(1, 64, 4))


def test_importing_the_port_loads_no_missing_package():
    """Every module of the port imports, and none of them loads JAX, PyYAML,
    PIL or tensorboard at import time (torch itself imports tqdm where it is
    installed, so tqdm is held by the source scan above)."""
    mods = sorted(".".join(p.relative_to(REPO).with_suffix("").parts)
                  for p in (REPO / "modest_tpu_torch").rglob("*.py"))
    mods = [m.removesuffix(".__init__") for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print([m for m in ('jax', 'flax', 'yaml', 'PIL', 'tensorboard') if m in sys.modules])")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]"]


ROUND_MODULES = ["eval/kitti_eval.py", "cli/test.py", "cli/evaluate.py",
                 "cli/generate_label_files.py", "cli/combine_labels.py", "cli/gen_gt_mask.py",
                 "cli/self_train.py"]


def test_the_round_modules_are_held_to_the_rules():
    """The self-training round's modules are among those the import scans
    above read, and its entry points load their configs without PyYAML or
    JAX: the two label configs and the shipped flagship file."""
    scanned = {str(p.relative_to(REPO)) for p in (REPO / "modest_tpu_torch").rglob("*.py")}
    assert {f"modest_tpu_torch/{m}" for m in ROUND_MODULES} <= scanned
    code = ("import sys\n"
            "from modest_tpu_torch.cli import (combine_labels, evaluate, gen_gt_mask,\n"
            "    generate_label_files, self_train, test)\n"
            "from modest_tpu_torch.cli.common import load_pipeline_config\n"
            "from modest_tpu_torch.cli.train import load_model_config\n"
            "for n in ('generate_label_files', 'combine_labels'):\n"
            "    load_pipeline_config(n, ['data_root=/d'])\n"
            "load_model_config('configs/models/lyft_models/pointrcnn_dynamic_obj.yaml')\n"
            "print([m for m in ('jax', 'flax', 'yaml', 'PIL', 'tensorboard') if m in sys.modules])")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]"]


def test_seeded_init_and_pcdet_state_dict_keys():
    a = build_network(Config(POINTRCNN_DYNAMIC_OBJ), 1, device="cpu", seed=5).state_dict()
    b = build_network(Config(POINTRCNN_DYNAMIC_OBJ), 1, device="cpu", seed=5).state_dict()
    c = build_network(Config(POINTRCNN_DYNAMIC_OBJ), 1, device="cpu", seed=6).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["point_head.cls_layers.0.weight"], c["point_head.cls_layers.0.weight"])
    for key in ("backbone_3d.SA_modules.0.mlps.1.3.weight",     # 2nd Linear of a BN stack
                "backbone_3d.SA_modules.3.mlps.0.7.running_var",
                "backbone_3d.FP_modules.3.mlp.0.weight",
                "point_head.cls_layers.6.bias",                  # the FC head's final Linear
                "roi_head.xyz_up_layer.2.bias",                  # USE_BN False: Linear, ReLU
                "roi_head.merge_down_layer.0.weight",
                "roi_head.SA_modules.2.mlps.0.1.running_mean",   # the tower always has BN
                "roi_head.reg_layers.6.weight"):
        assert key in a, key
    assert a["backbone_3d.FP_modules.0.mlp.0.weight"].shape == (128, 256 + 1)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_a_card(alone, tmp_path):
    """chip_smoke.py exits non-zero and prints no result line on a host
    without CUDA, and in a directory that holds nothing else of the repo."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    lines = proc.stdout.strip().splitlines()
    assert not lines or '"ok": true' not in lines[-1]
    assert all(not line.startswith("{") or "ok" not in json.loads(line) for line in lines)
