"""SECOND-IoU in modest_tpu_torch against the JAX package: the tiny config of
tests/test_part_a2.py::test_second_iou_forward_backward on the tiny SECOND
of tests/test_torch_grid_detectors.py, JAX's variables (seeded, from
``jax.eval_shape`` of its init) carried over by
``models/convert.py::second_iou_state_dict_from_jax``, the same toy batch.
One JAX train forward and one eval forward are shared by the module. Also
the rotated BEV grid alone, the build_network route and the shipped config
dict against its YAML. The CLIs run it in tests/test_torch_two_stage_cli.py."""
from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modest_tpu.models import second_iou as jsi
from modest_tpu_torch.models import api, build_network
from modest_tpu_torch.models import second_iou as si
from modest_tpu_torch.models.convert import second_iou_state_dict_from_jax
from modest_tpu_torch.utils.config import Config
from tests.test_torch_grid_detectors import geometry, second_model_cfg
from tests.torch_detector_pair import (MAX_VOXELS, bridge_covers_every_leaf, jax_model,
                                       port_model, run_jax)

TOL = {"rtol": 1e-4, "atol": 1e-4}
YAML = "configs/models/lyft_models/second_iou_dynamic_obj.yaml"


def second_iou_model_cfg():
    cfg = second_model_cfg()
    cfg["NAME"] = "SECONDNetIoU"
    cfg["ROI_HEAD"] = {
        "NAME": "SECONDHead", "CLASS_AGNOSTIC": True,
        "GRID_SIZE": 4, "SHARED_FC": [16], "IOU_FC": [16],
        "NMS_CONFIG": {
            "TRAIN": {"NMS_PRE_MAXSIZE": 128, "NMS_POST_MAXSIZE": 32, "NMS_THRESH": 0.8},
            "TEST": {"NMS_PRE_MAXSIZE": 128, "NMS_POST_MAXSIZE": 16, "NMS_THRESH": 0.7},
        },
        "LOSS_CONFIG": {"LOSS_WEIGHTS": {"rcnn_iou_weight": 1.0}},
    }
    return cfg


@pytest.fixture(scope="module")
def pair():
    cfg = second_iou_model_cfg()
    run = run_jax(jax_model(jsi.SECONDIoU, cfg), Config(cfg), jsi.second_iou_loss)
    run.cfg, run.port = Config(cfg), port_model(cfg)
    return run


def _load(pair, stats):
    pair.port.load_state_dict(second_iou_state_dict_from_jax(pair.params, stats, pair.cfg))


@pytest.mark.parametrize("g", [1, 4, 7])
def test_roi_bev_grid_matches_jax(g):
    rng = np.random.RandomState(0)
    rois = np.concatenate([rng.uniform(-5, 5, (2, 9, 3)), rng.uniform(0.5, 4, (2, 9, 3)),
                           rng.uniform(-np.pi, np.pi, (2, 9, 1))], -1).astype(np.float32)
    got = si.roi_bev_grid(torch.from_numpy(rois), g)
    assert got.shape == (2, 9, g * g, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(jsi.roi_bev_grid(jnp.asarray(rois), g)),
                               rtol=1e-5, atol=1e-5)


def test_bridge_covers_every_leaf(pair):
    sd = second_iou_state_dict_from_jax(pair.params, pair.stats0, pair.cfg)
    bridge_covers_every_leaf(sd, pair.port, pair.params, pair.stats0)


def test_eval_forward_and_boxes_match_jax(pair):
    """The RoIs and their validity, the IoU logits (the eval scores) within
    1e-4, the final boxes 1:1 with the post-processing of JAX's outputs."""
    _load(pair, pair.stats1)
    pair.port.eval()
    with torch.inference_mode():
        out = pair.port(torch.from_numpy(pair.pts), max_voxels=MAX_VOXELS)
    want = pair.eval
    np.testing.assert_array_equal(out["roi_valid"].numpy(), want["roi_valid"])
    assert out["roi_valid"].any()
    for key in ("rois", "rcnn_iou", "batch_cls_preds", "batch_box_preds", "cls_preds",
                "box_preds"):
        np.testing.assert_allclose(out[key].numpy(), want[key], **TOL, err_msg=key)
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


def test_train_forward_and_loss_match_jax(pair):
    """Anchor labels equal, IoU targets and logits within 1e-4, every loss
    term within rtol 1e-3, the running statistics the forward leaves, and a
    finite gradient for every weight."""
    _load(pair, pair.stats0)
    gt = torch.from_numpy(pair.gt)
    pair.port.train()
    out = pair.port(torch.from_numpy(pair.pts), gt, max_voxels=MAX_VOXELS)
    loss, metrics = api.compute_loss(out, gt, pair.cfg, 1)
    np.testing.assert_array_equal(out["box_cls_labels"].numpy(), pair.out["box_cls_labels"])
    for key in ("rois", "iou_targets", "rcnn_iou"):
        np.testing.assert_allclose(out[key].detach().numpy(), pair.out[key], **TOL, err_msg=key)
    assert set(metrics) == set(pair.metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(v.item(), pair.metrics[k], rtol=1e-3, err_msg=k)
    assert pair.metrics["iou_loss"] > 0 and pair.out["iou_targets"].max() > 0
    loss.backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in pair.port.parameters())
    own = pair.port.state_dict()
    want = second_iou_state_dict_from_jax(pair.params, pair.stats1, pair.cfg)
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) >= 20
    for k in stats:
        np.testing.assert_allclose(own[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    pair.port.eval()


def test_build_network_routes_second_iou_and_draws_no_rois():
    for name in ("SECONDNetIoU", "SECONDIoU"):
        cfg = second_iou_model_cfg()
        cfg["NAME"] = name
        model = build_network(Config(cfg), 1, device="cpu", dataset=geometry("second"))
        assert isinstance(model, si.SECONDIoU)
        assert not api.samples_rois(Config(cfg)) and not api.is_grid_model(Config(cfg))
    with pytest.raises(ValueError, match="geometry"):
        build_network(Config(second_iou_model_cfg()), 1, device="cpu")


@pytest.mark.parametrize("section", ["CLASS_NAMES", "DATA_CONFIG", "MODEL", "OPTIMIZATION"])
def test_second_iou_dict_equals_the_jax_loaders_yaml(section):
    from modest_tpu.utils.config import cfg_from_yaml_file
    from modest_tpu_torch import configs

    want = cfg_from_yaml_file(YAML).to_dict()
    full = configs.SECOND_IOU_DYNAMIC_OBJ_FULL
    assert list(want) == list(full)
    assert json.dumps(full[section]) == json.dumps(want[section])
    assert configs.SHIPPED_MODEL_CONFIGS[YAML] is full
