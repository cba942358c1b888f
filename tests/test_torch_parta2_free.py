"""The anchor-free Part-A2 (``PartA2Free``) in modest_tpu_torch against the JAX
package: the tiny Part-A2 of tests/test_torch_part_a2.py made anchor-free as
tests/test_part_a2.py::parta2_free_model_cfg does (NAME PointRCNN, the UNetV2
backbone, a point head with ``PointResidualCoder`` mean sizes, DISABLE_PART),
here for three classes on tests/test_torch_multiclass.py's scans. JAX's
variables (seeded, from ``jax.eval_shape`` of its init) are carried over by
``models/convert.py::parta2_free_state_dict_from_jax``; one jitted JAX eval
forward + post-processing with the seeded statistics is shared by the
module (the train forward is tests/test_torch_parta2_free_train.py's). No
JAX gradient is taken. Also the build route."""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from modest_tpu.models import api as japi
from modest_tpu.models import part_a2 as jpa
from modest_tpu_torch.models import api, build_network
from modest_tpu_torch.models import part_a2 as pa
from modest_tpu_torch.models import sparse_conv as sc
from modest_tpu_torch.models.convert import parta2_free_state_dict_from_jax
from modest_tpu_torch.utils.config import Config
from tests.test_torch_multiclass import GS, VS, three_class_batch
from tests.test_torch_multiclass_models import _geometry
from tests.test_torch_grid_detectors import PCR
from tests.test_torch_part_a2 import parta2_model_cfg
from tests.torch_detector_pair import MAX_VOXELS, bridge_covers_every_leaf, run_jax
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = {"rtol": 1e-4, "atol": 1e-4}
MEAN_SIZES = [[3.9, 1.6, 1.56], [0.8, 0.6, 1.73], [1.76, 0.6, 1.73]]


def parta2_free_model_cfg():
    cfg = parta2_model_cfg()
    cfg["NAME"] = "PointRCNN"
    cfg["BACKBONE_3D"] = {"NAME": "UNetV2", "RETURN_ENCODED_TENSOR": False}
    cfg["POINT_HEAD"] = {
        "NAME": "PointIntraPartOffsetHead", "CLS_FC": [16], "PART_FC": [16], "REG_FC": [16],
        "CLASS_AGNOSTIC": False,
        "TARGET_CONFIG": {"GT_EXTRA_WIDTH": [0.2, 0.2, 0.2], "BOX_CODER": "PointResidualCoder",
                          "BOX_CODER_CONFIG": {"use_mean_size": True,
                                               "mean_size": copy.deepcopy(MEAN_SIZES)}},
        "LOSS_CONFIG": {"LOSS_WEIGHTS": {"point_cls_weight": 1.0, "point_box_weight": 1.0,
                                         "point_part_weight": 1.0, "code_weights": [1.0] * 8}},
    }
    cfg["ROI_HEAD"]["DISABLE_PART"] = True
    for key in ("DENSE_HEAD", "VFE", "MAP_TO_BEV", "BACKBONE_2D"):
        cfg.pop(key)
    return cfg


@pytest.fixture(scope="module")
def pair():
    cfg = Config(parta2_free_model_cfg())
    jmodel = jpa.PartA2Free(model_cfg=cfg, num_class=3, point_cloud_range=PCR, voxel_size=VS,
                            grid_size=GS)
    run = run_jax(jmodel, cfg, None, forwards=("eval",), batch=three_class_batch(),
                  post=lambda out: japi.post_process(out, cfg))
    run.cfg = cfg
    run.port = build_network(cfg, 3, device="cpu", dataset=_geometry())
    return run


def _load(pair, stats):
    pair.port.load_state_dict(parta2_free_state_dict_from_jax(pair.params, stats, pair.cfg))


def test_build_network_routes_part_a2_free():
    cfg = Config(parta2_free_model_cfg())
    model = build_network(cfg, 3, device="cpu", dataset=_geometry())
    assert isinstance(model, pa.PartA2Free) and isinstance(model.backbone_3d, sc.SparseUNet)
    assert api.is_parta2_free(cfg) and api.samples_rois(cfg) and not api.is_grid_model(cfg)
    with pytest.raises(ValueError, match="geometry"):
        build_network(cfg, 3, device="cpu")


def test_bridge_covers_every_leaf(pair):
    sd = parta2_free_state_dict_from_jax(pair.params, pair.stats0, pair.cfg)
    bridge_covers_every_leaf(sd, pair.port, pair.params, pair.stats0)
    compared = sum(1 for name, p in pair.port.named_parameters()
                   if torch.equal(p.detach(), sd[name]))
    assert compared == len(list(pair.port.parameters()))


def test_eval_forward_and_boxes_match_jax(pair):
    """The point head's logits and residuals, the decoded voxel boxes, the
    RoIs and their validity, the RCNN heads and the refined boxes within
    1e-4; the final boxes, scores and labels of ``post_process`` equal
    JAX's."""
    _load(pair, pair.stats1)
    pair.port.eval()
    with torch.inference_mode():
        out = pair.port(torch.from_numpy(pair.pts), max_voxels=MAX_VOXELS)
        final = api.post_process(out, pair.cfg)
    want = pair.eval
    np.testing.assert_array_equal(out["roi_valid"].numpy(), want["roi_valid"])
    assert out["roi_valid"].any()
    np.testing.assert_array_equal(out["roi_labels"].numpy(), want["roi_labels"])
    for key in ("point_cls_preds", "point_box_preds", "point_boxes_decoded", "part_reg",
                "rois", "rcnn_cls", "rcnn_reg", "batch_cls_preds", "batch_box_preds"):
        np.testing.assert_allclose(out[key].numpy(), want[key], **TOL, err_msg=key)
    ref = pair.final
    np.testing.assert_array_equal(final["valid"].numpy(), ref["valid"])
    v = final["valid"].numpy()
    assert v.sum() > 0
    np.testing.assert_array_equal(final["labels"].numpy()[v], ref["labels"][v])
    np.testing.assert_allclose(final["boxes"].numpy()[v], ref["boxes"][v], **TOL)
    np.testing.assert_allclose(final["scores"].numpy()[v], ref["scores"][v], **TOL)
