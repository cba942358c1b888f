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
