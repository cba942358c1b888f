"""Part-A2 in modest_tpu_torch against the JAX package: the tiny config of
tests/test_part_a2.py (copied below, on the tiny SECOND of
tests/test_torch_grid_detectors.py), JAX's variables (seeded, from
``jax.eval_shape`` of its init) carried over by
``models/convert.py::parta2_state_dict_from_jax``, the same toy batch. The
JAX train forward (its RoI sampler's key recorded and handed to the port as
draws) is in tests/test_torch_part_a2_train.py; here one eval forward
with the seeded statistics is shared by the module. Also the
build_network route and the refusal of the anchor-free PartA2Free, and the
shipped config dict against its YAML. Its pieces alone are held to JAX in
tests/test_torch_part_a2_ops.py."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from modest_tpu.models import part_a2 as jpa
from modest_tpu_torch.models import api, build_network
from modest_tpu_torch.models import part_a2 as pa
from modest_tpu_torch.models import sparse_conv as sc
from modest_tpu_torch.models.convert import parta2_state_dict_from_jax
from modest_tpu_torch.utils.config import Config
from tests.test_torch_grid_detectors import geometry, second_model_cfg
from tests.torch_detector_pair import (MAX_VOXELS, bridge_covers_every_leaf, jax_model,
                                       port_model, run_jax)

TOL = {"rtol": 1e-4, "atol": 1e-4}
YAML = "configs/models/lyft_models/part_a2_dynamic_obj.yaml"


def parta2_model_cfg():
    cfg = second_model_cfg()
    cfg["NAME"] = "PartA2"
    cfg["BACKBONE_3D"] = {"NAME": "UNetV2"}
    cfg["POINT_HEAD"] = {
        "NAME": "PointIntraPartOffsetHead", "CLS_FC": [16], "PART_FC": [16],
        "CLASS_AGNOSTIC": True,
        "LOSS_CONFIG": {"LOSS_WEIGHTS": {"point_cls_weight": 1.0, "point_part_weight": 1.0}},
    }
    cfg["ROI_HEAD"] = {
        "NAME": "PartA2FCHead", "CLASS_AGNOSTIC": True,
        "SHARED_FC": [32], "CLS_FC": [16], "REG_FC": [16], "DP_RATIO": 0.0,
        "NMS_CONFIG": {
            "TRAIN": {"NMS_TYPE": "nms_gpu", "MULTI_CLASSES_NMS": False,
                      "NMS_PRE_MAXSIZE": 128, "NMS_POST_MAXSIZE": 32, "NMS_THRESH": 0.8},
            "TEST": {"NMS_TYPE": "nms_gpu", "MULTI_CLASSES_NMS": False,
                     "NMS_PRE_MAXSIZE": 128, "NMS_POST_MAXSIZE": 16, "NMS_THRESH": 0.7},
        },
        "ROI_AWARE_POOL": {"POOL_SIZE": 4, "NUM_FEATURES": 16, "MAX_POINTS_PER_VOXEL": 128},
        "CONV_TOWER": {"NUM_FILTERS": [16, 16], "STRIDES": [1, 2]},
        "TARGET_CONFIG": {
            "BOX_CODER": "ResidualCoder", "ROI_PER_IMAGE": 16, "FG_RATIO": 0.5,
            "SAMPLE_ROI_BY_EACH_CLASS": True, "CLS_SCORE_TYPE": "roi_iou",
            "CLS_FG_THRESH": 0.75, "CLS_BG_THRESH": 0.25, "CLS_BG_THRESH_LO": 0.1,
            "HARD_BG_RATIO": 0.8, "REG_FG_THRESH": 0.55,
        },
        "LOSS_CONFIG": {
            "CLS_LOSS": "BinaryCrossEntropy", "REG_LOSS": "smooth-l1",
            "CORNER_LOSS_REGULARIZATION": True,
            "LOSS_WEIGHTS": {"rcnn_cls_weight": 1.0, "rcnn_reg_weight": 1.0,
                             "rcnn_corner_weight": 1.0, "code_weights": [1.0] * 7},
        },
    }
    return cfg


@pytest.fixture(scope="module")
def pair():
    cfg = parta2_model_cfg()
    run = run_jax(jax_model(jpa.PartA2, cfg), Config(cfg), jpa.parta2_loss, jpa,
                  forwards=("eval",))
    run.cfg, run.port = Config(cfg), port_model(cfg)
    return run


def _load(pair, stats):
    pair.port.load_state_dict(parta2_state_dict_from_jax(pair.params, stats, pair.cfg))


def test_bridge_covers_every_leaf(pair):
    sd = parta2_state_dict_from_jax(pair.params, pair.stats0, pair.cfg)
    bridge_covers_every_leaf(sd, pair.port, pair.params, pair.stats0)


def test_eval_forward_and_boxes_match_jax(pair):
    """The RoIs and their validity, the point heads and RCNN logits within
    1e-4, the box residuals and refined boxes within 2e-3, the final boxes
    1:1 with the post-processing of JAX's outputs."""
    _load(pair, pair.stats1)
    pair.port.eval()
    with torch.inference_mode():
        out = pair.port(torch.from_numpy(pair.pts), max_voxels=MAX_VOXELS)
    want = pair.eval
    np.testing.assert_array_equal(out["roi_valid"].numpy(), want["roi_valid"])
    assert out["roi_valid"].any()
    for key in ("rois", "seg_logits", "part_reg", "rcnn_cls"):
        np.testing.assert_allclose(out[key].numpy(), want[key], **TOL, err_msg=key)
    for key in ("rcnn_reg", "batch_box_preds"):
        np.testing.assert_allclose(out[key].numpy(), want[key], rtol=1e-4, atol=2e-3,
                                   err_msg=key)
    final = api.post_process(out, pair.cfg)
    ref = api.post_process({k: torch.from_numpy(np.array(want[k])) for k in
                            ("batch_cls_preds", "batch_box_preds", "roi_valid", "roi_labels",
                             "rois")}, pair.cfg)
    for i in range(len(pair.pts)):
        v, jv = final["valid"][i].numpy(), ref["valid"][i].numpy()
        assert v.sum() == jv.sum() > 0
        np.testing.assert_allclose(final["boxes"][i].numpy()[v], ref["boxes"][i].numpy()[jv],
                                   rtol=1e-4, atol=2e-3)
        np.testing.assert_allclose(final["scores"][i].numpy()[v], ref["scores"][i].numpy()[jv],
                                   **TOL)


def test_build_network_routes_part_a2_and_refuses_part_a2_free():
    cfg = Config(parta2_model_cfg())
    model = build_network(cfg, 1, device="cpu", dataset=geometry("second"))
    assert isinstance(model, pa.PartA2) and isinstance(model.backbone_3d, sc.SparseUNet)
    assert api.samples_rois(cfg)
    free = parta2_model_cfg()
    free["NAME"] = "PointRCNN"
    with pytest.raises(NotImplementedError, match="PartA2Free"):
        build_network(Config(free), 1, device="cpu", dataset=geometry("second"))
    bad = parta2_model_cfg()
    bad["BACKBONE_3D"] = {"NAME": "VoxelBackBone8x"}
    with pytest.raises(NotImplementedError, match="UNetV2|sparse backbone"):
        build_network(Config(bad), 1, device="cpu", dataset=geometry("second"))


@pytest.mark.parametrize("section", ["CLASS_NAMES", "DATA_CONFIG", "MODEL", "OPTIMIZATION"])
def test_part_a2_dict_equals_the_jax_loaders_yaml(section):
    from modest_tpu.utils.config import cfg_from_yaml_file
    from modest_tpu_torch import configs

    want = cfg_from_yaml_file(YAML).to_dict()
    full = configs.PART_A2_DYNAMIC_OBJ_FULL
    assert list(want) == list(full)
    assert json.dumps(full[section]) == json.dumps(want[section])
    assert configs.SHIPPED_MODEL_CONFIGS[YAML] is full
