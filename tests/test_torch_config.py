"""Override values in the PyTorch port vs PyYAML.

The JAX CLIs read a ``key=value`` override's value with ``yaml.safe_load``;
the port reads it without PyYAML (the card's machine has none) and must give
the same value and type, or raise ``ValueError`` where YAML would read the
text as something other than a plain scalar or a flow collection.
"""
import math

import pytest

from modest_tpu.utils.config import Config as JConfig
from modest_tpu.utils.config import cfg_from_kv_overrides as j_cfg_from_kv_overrides
from modest_tpu_torch.utils.config import Config, cfg_from_kv_overrides, parse_value
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

yaml = pytest.importorskip("yaml")


def _same(a, b):
    """Equal values of equal types, NaN equal to NaN, recursively."""
    if type(a) is not type(b):
        return False
    if isinstance(a, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[key], b[key]) for key in a)
    return a == b


@pytest.mark.parametrize("text", [
    # the values on which the JSON-first reading disagreed with PyYAML
    "[Car,Pedestrian]", "[Car, Pedestrian, Cyclist]", "1e-3", "1.5e3", "0x1F", "017", "1_000",
    "1:30", ".inf", "NaN", "Infinity", "2.", "{a: 1}",
    # forms that agreed before and must still agree
    "30", "-1", "0.3", "1.5e-3", "true", "False", "YES", "off", "null", "~", "",
    "[[-10, 10], [-5, 5]]", "/data/x", "PCA", '"quoted"',
    # more of YAML 1.1's scalars
    "-.inf", "+.INF", ".NaN", ".5", "-.5", "1.0e+3", "0b1_01", "-0x1f", "+12", "0", "00", "09",
    "1:30.5", "190:20:30", "1:60", "0o17", "1__0", "1._5",
    # quoting, nesting and the characters a plain scalar may hold
    "'it''s'", '"tab\\there \\x41\\u00e9"', "[a b, 'c, d', \"e\"]", "[]", "{}", "[1,]",
    "{a: , b: [1, {c: ~}], 'd': \"e\"}", "{a}", "{a:1}", "{\"a\":1}", "[a:b, http://x]",
    "http://x:80/a", "a:b", "-a", "?a", ":a", "a#b", "a, b", "a]", "  padded  ", "a  b",
])
def test_parse_value_reads_as_pyyaml_does(text):
    got, want = parse_value(text), yaml.safe_load(text)
    assert _same(got, want), (got, want)


@pytest.mark.parametrize("text", [
    "2001-12-14",           # a timestamp
    "2001-12-14 1:00:00",
    "&a 1", "*a", "!!str 1",  # anchors, aliases, tags
    "a: b", "key:",          # a block mapping
    "- a", "-", "? a",      # a block sequence, a complex key
    "x #c", "#c",           # comments
    "|", ">",               # block scalars
    "---", "...",           # document markers
    "[a: 1]", "[?a]", "[a", "{a: b: c}", "[1]x", "'open", '"\\q"', "a\tb", "<<", "=",
])
def test_parse_value_refuses_what_yaml_reads_otherwise(text):
    with pytest.raises(ValueError, match="override value"):
        parse_value(text)


@pytest.mark.parametrize("old,text", [
    (["Car"], "[Car,Pedestrian]"),
    (True, "0"),
    (False, "yes"),
    (0.3, "1e-3"),
    (16, "0x10"),
    ({"a": 1}, "{a: 2, b: [x]}"),
])
def test_overrides_match_the_jax_cli(old, text):
    got = cfg_from_kv_overrides([f"model.value={text}"], Config({"model": {"value": old}}))
    want = j_cfg_from_kv_overrides([f"model.value={text}"], JConfig({"model": {"value": old}}))
    assert _same(got.to_dict(), want.to_dict())


def test_class_names_override_reads_a_flow_list():
    """``class_names=[Car,Pedestrian]``: a list in both CLIs (the port used
    to keep the string and raise "expected list")."""
    base = {"class_names": ["Car"]}
    got = cfg_from_kv_overrides(["class_names=[Car,Pedestrian]"], Config(base))
    want = j_cfg_from_kv_overrides(["class_names=[Car,Pedestrian]"], JConfig(base))
    assert got.class_names == want.class_names == ["Car", "Pedestrian"]


def test_a_list_override_must_stay_a_list():
    for cfg_fn, config in ((cfg_from_kv_overrides, Config), (j_cfg_from_kv_overrides, JConfig)):
        with pytest.raises(ValueError, match="expected list"):
            cfg_fn(["class_names=Car"], config({"class_names": ["Car", "Pedestrian"]}))


FLAGSHIP_YAML = "configs/models/lyft_models/pointrcnn_dynamic_obj.yaml"


@pytest.mark.parametrize("section", ["CLASS_NAMES", "DATA_CONFIG", "MODEL", "OPTIMIZATION"])
def test_flagship_dicts_equal_the_jax_loaders_yaml(section):
    """configs.py ships the flagship file whole, its _BASE_CONFIG_ dataset
    file merged in, as modest_tpu.utils.config reads it."""
    from modest_tpu.utils.config import cfg_from_yaml_file as j_cfg_from_yaml_file
    from modest_tpu_torch.configs import POINTRCNN_DYNAMIC_OBJ_FULL, SHIPPED_MODEL_CONFIGS

    want = j_cfg_from_yaml_file(FLAGSHIP_YAML).to_dict()
    assert list(want) == list(POINTRCNN_DYNAMIC_OBJ_FULL)
    assert _same(POINTRCNN_DYNAMIC_OBJ_FULL[section], want[section])
    assert SHIPPED_MODEL_CONFIGS[FLAGSHIP_YAML] is POINTRCNN_DYNAMIC_OBJ_FULL


@pytest.mark.parametrize("section", ["CLASS_NAMES", "DATA_CONFIG", "MODEL", "OPTIMIZATION"])
@pytest.mark.parametrize("name", ["pointpillar", "second"])
def test_grid_dicts_equal_the_jax_loaders_yaml(name, section):
    """configs.py ships the PointPillars and SECOND files whole, as
    modest_tpu.utils.config reads them."""
    from modest_tpu.utils.config import cfg_from_yaml_file as j_cfg_from_yaml_file
    from modest_tpu_torch import configs

    yaml = f"configs/models/lyft_models/{name}_dynamic_obj.yaml"
    full = getattr(configs, f"{name.upper()}_DYNAMIC_OBJ_FULL")
    want = j_cfg_from_yaml_file(yaml).to_dict()
    assert list(want) == list(full)
    assert _same(full[section], want[section])
    assert configs.SHIPPED_MODEL_CONFIGS[yaml] is full


NUSCENES_BOSTON_YAML = "configs/models/nuscenes_boston_models/pointrcnn_dynamic_obj.yaml"


@pytest.mark.parametrize("section", ["CLASS_NAMES", "DATA_CONFIG", "MODEL", "OPTIMIZATION"])
def test_nuscenes_boston_dicts_equal_the_jax_loaders_yaml(section):
    """configs.py ships the nuScenes-Boston PointRCNN file whole, its
    _BASE_CONFIG_ dataset file merged in, as modest_tpu.utils.config reads
    it: the flagship's model at 6144 points a scan and 80 epochs."""
    from modest_tpu.utils.config import cfg_from_yaml_file as j_cfg_from_yaml_file
    from modest_tpu_torch import configs

    full = configs.NUSCENES_BOSTON_POINTRCNN_DYNAMIC_OBJ_FULL
    want = j_cfg_from_yaml_file(NUSCENES_BOSTON_YAML).to_dict()
    assert list(want) == list(full)
    assert _same(full[section], want[section])
    assert configs.SHIPPED_MODEL_CONFIGS[NUSCENES_BOSTON_YAML] is full
    assert full["MODEL"] is configs.POINTRCNN_DYNAMIC_OBJ
    assert full["DATA_CONFIG"]["DATA_PROCESSOR"][1]["NUM_POINTS"] == {"train": 6144,
                                                                      "test": 6144}


def test_nuscenes_boston_dataset_base_equals_its_yaml():
    """Every key of configs/datasets/nuscenes_boston_dynamic_obj.yaml, as
    PyYAML reads it, is the shipped DATA_CONFIG's; the model file's
    DATA_PROCESSOR replaces the base's."""
    import yaml

    from modest_tpu_torch.configs import NUSCENES_BOSTON_POINTRCNN_DYNAMIC_OBJ_FULL as full

    with open("configs/datasets/nuscenes_boston_dynamic_obj.yaml") as f:
        base = yaml.safe_load(f)
    data = full["DATA_CONFIG"]
    assert list(base) == list(data)
    for key in base:
        if key != "DATA_PROCESSOR":
            assert _same(data[key], base[key]), key
    # the model file keeps the base's steps and adds its 6144-point sampling
    assert [p for p in data["DATA_PROCESSOR"] if p["NAME"] != "sample_points"] \
        == base["DATA_PROCESSOR"]


KITTI_STEMS = ["pointrcnn", "pointrcnn_iou", "second", "pointpillar", "second_multihead",
               "pv_rcnn", "second_iou", "PartA2", "PartA2_free", "voxel_rcnn_car"]


CADDN_STEMS = ["CaDDN", "CaDDN_deeplab"]


@pytest.mark.parametrize("section", ["CLASS_NAMES", "DATA_CONFIG", "MODEL", "OPTIMIZATION"])
@pytest.mark.parametrize("stem", [*KITTI_STEMS, *CADDN_STEMS])
def test_kitti_dicts_equal_the_jax_loaders_yaml(stem, section):
    """configs.py ships each KITTI file whole, configs/datasets/kitti_dataset.yaml
    merged in, as modest_tpu.utils.config reads it; ``KITTI_<NAME>`` is its
    MODEL section."""
    from modest_tpu.utils.config import cfg_from_yaml_file as j_cfg_from_yaml_file
    from modest_tpu_torch import configs

    yaml_file = f"configs/models/kitti_models/{stem}.yaml"
    full = configs.KITTI_CONFIGS[stem]
    want = j_cfg_from_yaml_file(yaml_file).to_dict()
    assert list(want) == list(full)
    assert _same(full[section], want[section])
    assert configs.SHIPPED_MODEL_CONFIGS[yaml_file] is full
    name = {"PartA2": "PART_A2", "PartA2_free": "PART_A2_FREE"}.get(stem, stem.upper())
    assert full["MODEL"] is getattr(configs, f"KITTI_{name}")


def test_kitti_dataset_base_equals_its_yaml():
    from modest_tpu_torch.configs import KITTI_DATA_BASE

    with open("configs/datasets/kitti_dataset.yaml") as f:
        base = yaml.safe_load(f)
    assert list(base) == [*KITTI_DATA_BASE, "DATA_PROCESSOR"]
    for key in KITTI_DATA_BASE:
        assert _same(KITTI_DATA_BASE[key], base[key]), key


@pytest.mark.parametrize("stem", ["cbgs_second_multihead", "cbgs_pp_multihead"])
def test_cbgs_model_sections_equal_the_jax_loaders_yaml(stem):
    """The CBGS files' MODEL sections, class names and the geometry their
    DATA_CONFIG records, which ``CBGS_GEOMETRY`` reads off the whole dicts."""
    from modest_tpu.utils.config import cfg_from_yaml_file as j_cfg_from_yaml_file
    from modest_tpu_torch import configs

    want = j_cfg_from_yaml_file(f"configs/models/nuscenes_models/{stem}.yaml").to_dict()
    assert _same(getattr(configs, stem.upper()), want["MODEL"])
    assert configs.CBGS_CLASS_NAMES == want["CLASS_NAMES"]
    data = want["DATA_CONFIG"]
    assert configs.CBGS_POINT_CLOUD_RANGE == data["POINT_CLOUD_RANGE"]
    assert list(configs.CBGS_GEOMETRY[stem]) == [data["VOXEL_SIZE"], data["GRID_SIZE"]]
    assert len(data["POINT_FEATURE_ENCODING"]["used_feature_list"]) \
        == configs.CBGS_NUM_POINT_FEATURES


NUSCENES_WAYMO_FILES = [("nuscenes_models", "CBGS_CONFIGS", "cbgs_second_multihead"),
                        ("nuscenes_models", "CBGS_CONFIGS", "cbgs_pp_multihead"),
                        ("waymo_models", "WAYMO_CONFIGS", "pv_rcnn"),
                        ("waymo_models", "WAYMO_CONFIGS", "second"),
                        ("waymo_models", "WAYMO_CONFIGS", "PartA2")]


@pytest.mark.parametrize("section", ["CLASS_NAMES", "DATA_CONFIG", "MODEL", "OPTIMIZATION"])
@pytest.mark.parametrize("folder,table,stem", NUSCENES_WAYMO_FILES)
def test_nuscenes_and_waymo_dicts_equal_the_jax_loaders_yaml(folder, table, stem, section):
    """configs.py ships the CBGS and Waymo files whole, their dataset base
    merged in, as modest_tpu.utils.config reads them; ``cli/train.py`` takes
    them without PyYAML."""
    from modest_tpu.utils.config import cfg_from_yaml_file as j_cfg_from_yaml_file
    from modest_tpu_torch import configs

    yaml_file = f"configs/models/{folder}/{stem}.yaml"
    full = getattr(configs, table)[stem]
    want = j_cfg_from_yaml_file(yaml_file).to_dict()
    assert list(want) == list(full)
    assert _same(full[section], want[section])
    assert configs.SHIPPED_MODEL_CONFIGS[yaml_file] is full


@pytest.mark.parametrize("name", ["nuscenes", "waymo"])
def test_nuscenes_and_waymo_dataset_bases_equal_their_yaml(name):
    from modest_tpu_torch import configs

    with open(f"configs/datasets/{name}_dataset.yaml") as f:
        base = yaml.safe_load(f)
    got = getattr(configs, f"{name.upper()}_DATASET_BASE")
    assert list(base) == list(got)
    assert _same(got, base)


@pytest.mark.parametrize("stem", ["pv_rcnn", "second", "PartA2"])
def test_waymo_dicts_build_on_the_cpu(stem):
    """Each shipped Waymo dict at full width on the CPU, with the geometry
    its data section records (1504 x 1504 x 40 voxels of 0.1 x 0.1 x 0.15 m)
    and 5-feature points: three classes' anchors at stride 8, and PV-RCNN's
    raw-points VSA source on the 2 features past xyz."""
    import types

    import numpy as np

    from modest_tpu_torch import configs
    from modest_tpu_torch.models import build_network

    full = configs.WAYMO_CONFIGS[stem]
    data = full["DATA_CONFIG"]
    vs = data["DATA_PROCESSOR"][-1]["VOXEL_SIZE"]
    pcr = data["POINT_CLOUD_RANGE"]
    gs = np.round((np.asarray(pcr[3:]) - pcr[:3]) / vs).astype(int)
    assert gs.tolist() == [1504, 1504, 40]
    dataset = types.SimpleNamespace(
        point_cloud_range=np.asarray(pcr, np.float32), voxel_size=vs, grid_size=gs,
        class_names=full["CLASS_NAMES"],
        point_feature_encoder=types.SimpleNamespace(num_point_features=len(
            data["POINT_FEATURE_ENCODING"]["used_feature_list"])))
    model = build_network(Config(full["MODEL"]), 3, device="cpu", dataset=dataset)
    assert model.anchors.shape == (188 * 188 * 6, 7)
    if stem == "pv_rcnn":
        assert model.state_dict()["vsa.raw_points.0.0.weight"].shape[1] == 5


@pytest.mark.parametrize("stem", [*KITTI_STEMS, "cbgs_second_multihead", "cbgs_pp_multihead"])
def test_kitti_and_cbgs_dicts_build_on_the_cpu(stem):
    """``build_network(..., device="cpu")`` builds every shipped KITTI dict
    and both CBGS model sections at full width, with the data geometry their
    files give: the route each takes, and its anchor count."""
    import types

    import numpy as np

    from modest_tpu_torch import configs
    from modest_tpu_torch.models import build_network
    from modest_tpu_torch.models.anchor_head_multi import AnchorHeadMulti
    from modest_tpu_torch.models.part_a2 import PartA2Free
    from modest_tpu_torch.models.sparse_conv import VoxelResBackBone8x

    if stem.startswith("cbgs"):
        model_cfg, names = getattr(configs, stem.upper()), configs.CBGS_CLASS_NAMES
        pcr = configs.CBGS_POINT_CLOUD_RANGE
        vs, gs = configs.CBGS_GEOMETRY[stem]
        features = configs.CBGS_NUM_POINT_FEATURES
    else:
        full = configs.KITTI_CONFIGS[stem]
        model_cfg, names = full["MODEL"], full["CLASS_NAMES"]
        pcr = full["DATA_CONFIG"]["POINT_CLOUD_RANGE"]
        vs = full["DATA_CONFIG"]["DATA_PROCESSOR"][-1].get("VOXEL_SIZE")
        gs = None if vs is None else np.round(
            (np.asarray(pcr[3:]) - pcr[:3]) / vs).astype(int).tolist()
        features = 4
    dataset = types.SimpleNamespace(point_cloud_range=pcr, voxel_size=vs, grid_size=gs,
                                    class_names=names, num_point_features=features)
    model = build_network(Config(model_cfg), len(names), device="cpu", dataset=dataset)
    assert not model.training
    grouped = stem in ("second", "pointpillar", "second_multihead") or stem.startswith("cbgs")
    assert grouped == isinstance(getattr(model, "dense_head", None), AnchorHeadMulti)
    assert isinstance(model, PartA2Free) == (stem == "PartA2_free")
    assert isinstance(getattr(model, "backbone_3d", None), VoxelResBackBone8x) \
        == (stem == "cbgs_second_multihead")
    if gs is not None and stem != "PartA2_free":
        stride = model_cfg["DENSE_HEAD"]["ANCHOR_GENERATOR_CONFIG"][0]["feature_map_stride"]
        per_loc = 2 * len(model_cfg["DENSE_HEAD"]["ANCHOR_GENERATOR_CONFIG"])
        assert model.anchors.shape == ((gs[0] // stride) * (gs[1] // stride) * per_loc, 7)


@pytest.mark.parametrize("stem", CADDN_STEMS)
def test_caddn_dicts_build_on_the_cpu(stem):
    """``build_network(..., device="cpu")`` builds both CaDDN dicts at full
    width on the geometry their dataset records (a 280 × 376 × 25 grid of
    0.16 m voxels, 80 depth bins, 3 classes): the encoder each names, the
    BEV collapse's 25 · 64 inputs, the anchors of a stride-2 map."""
    import types

    from modest_tpu_torch import configs
    from modest_tpu_torch.data.processor import DataProcessor
    from modest_tpu_torch.models import build_network
    from modest_tpu_torch.models.caddn import CaDDN

    full = Config(configs.KITTI_CONFIGS[stem])
    proc = DataProcessor(full.DATA_CONFIG.DATA_PROCESSOR, full.DATA_CONFIG.POINT_CLOUD_RANGE,
                         training=False)
    assert proc.grid_size.tolist() == [280, 376, 25]
    dataset = types.SimpleNamespace(point_cloud_range=full.DATA_CONFIG.POINT_CLOUD_RANGE,
                                    voxel_size=proc.voxel_size, grid_size=proc.grid_size)
    model = build_network(full.MODEL, len(full.CLASS_NAMES), device="cpu", dataset=dataset)
    assert isinstance(model, CaDDN) and not model.training
    assert (model.ddn is not None) == (stem == "CaDDN_deeplab")
    assert model.bev_collapse.in_features == 25 * 64
    assert model.anchors.shape == (140 * 188 * 6, 7)
    assert model.centers.shape == (280 * 376 * 25, 4)
    if stem == "CaDDN_deeplab":
        assert len(model.ddn.backbone.layer3) == 23
        assert model.ddn.classifier[4].out_channels == 81


@pytest.mark.parametrize("pairs", [
    ["OPTIMIZATION.LR", "0.002", "OPTIMIZATION.NUM_EPOCHS", "5"],
    ["DATA_CONFIG.FOV_POINTS_ONLY", "0", "CLASS_NAMES", "[Car,Pedestrian]"],
    ["MODEL.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_THRESH", "1e-1", "NEW.KEY", "x"],
    ["DATA_CONFIG.DATA_AUGMENTOR.DISABLE_AUG_LIST", "[gt_sampling, random_world_flip]"],
])
def test_cfg_from_list_matches_the_jax_cli(pairs):
    """``--set`` pairs, as the train CLI applies them."""
    from modest_tpu.utils.config import cfg_from_list as j_cfg_from_list
    from modest_tpu_torch.configs import POINTRCNN_DYNAMIC_OBJ_FULL
    from modest_tpu_torch.utils.config import cfg_from_list

    got = cfg_from_list(list(pairs), Config(POINTRCNN_DYNAMIC_OBJ_FULL))
    want = j_cfg_from_list(list(pairs), JConfig(POINTRCNN_DYNAMIC_OBJ_FULL))
    assert _same(got.to_dict(), want.to_dict())


def test_cfg_from_list_refuses_a_lone_key():
    from modest_tpu_torch.utils.config import cfg_from_list

    with pytest.raises(ValueError, match="pairs"):
        cfg_from_list(["OPTIMIZATION.LR"], Config({}))


def test_save_config_reads_back_through_the_yaml_loaders(tmp_path):
    from modest_tpu.utils.config import cfg_from_yaml_file as j_cfg_from_yaml_file
    from modest_tpu_torch.configs import POINTRCNN_DYNAMIC_OBJ_FULL
    from modest_tpu_torch.utils.config import cfg_from_yaml_file, save_config

    save_config(Config(POINTRCNN_DYNAMIC_OBJ_FULL), tmp_path / "cfg.yaml")
    assert _same(cfg_from_yaml_file(tmp_path / "cfg.yaml").to_dict(), POINTRCNN_DYNAMIC_OBJ_FULL)
    assert _same(j_cfg_from_yaml_file(tmp_path / "cfg.yaml").to_dict(), POINTRCNN_DYNAMIC_OBJ_FULL)


@pytest.mark.parametrize("name", ["generate_label_files", "combine_labels"])
def test_label_pipeline_dicts_equal_the_yaml(name):
    """The label-file and fusion configs ship as dicts equal to their YAML
    and load through cli/common.py as the JAX CLIs load them."""
    from modest_tpu.cli.common import load_pipeline_config as j_load_pipeline_config
    from modest_tpu.utils.config import cfg_from_yaml_file as j_cfg_from_yaml_file
    from modest_tpu_torch.cli.common import load_pipeline_config
    from modest_tpu_torch.configs import PIPELINE_CONFIGS

    assert PIPELINE_CONFIGS[name] == j_cfg_from_yaml_file(
        f"configs/pipeline/{name}.yaml").to_dict()
    overrides = ["work_dir=/w", "data_root=/d", "nms.threshold=0.2", "fov_only=false"]
    assert _same(load_pipeline_config(name, overrides).to_dict(),
                 j_load_pipeline_config(name, overrides).to_dict())
