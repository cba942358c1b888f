"""The 3-class grid detectors of modest_tpu_torch against the JAX package,
whole, on the toy scans of tests/test_torch_grid_detectors.py with a car,
a pedestrian and a cyclist: a SECOND with KITTI's 3-class anchor set (as
JAX routes it, through the grouped head, class-major anchors, no shared
conv) and a PV-RCNN's stage 1 (one head over location-major anchors with
per-anchor thresholds and classes, JAX's ``single_head_anchor_setup``).
JAX's variables are seeded from ``jax.eval_shape`` of its init and carried
over by ``models/convert.py``; one JAX run per model, no JAX gradient.
Labels exactly, floats within 1e-4, losses rtol 1e-4. The pieces alone are
in tests/test_torch_multiclass.py."""
from __future__ import annotations

import copy
import types

import numpy as np
import pytest
import torch

from modest_tpu.models import grid_detectors as jgd
from modest_tpu.models import pv_rcnn as jpv
from modest_tpu.utils.config import Config as JConfig
from modest_tpu_torch.models import build_network
from modest_tpu_torch.models import grid_detectors as gd
from modest_tpu_torch.models.convert import grid_state_dict_from_jax, pvrcnn_state_dict_from_jax
from modest_tpu_torch.utils.config import Config
from tests.test_torch_grid_detectors import PCR, second_model_cfg
from tests.test_torch_multiclass import GS, KITTI_ANCHORS, NAMES, VS, three_class_batch
from tests.test_torch_pv_rcnn import pvrcnn_model_cfg
from tests.torch_detector_pair import MAX_VOXELS, bridge_covers_every_leaf, run_jax
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = {"rtol": 1e-4, "atol": 1e-4}


def three_class_second_cfg():
    cfg = second_model_cfg()
    cfg["DENSE_HEAD"]["ANCHOR_GENERATOR_CONFIG"] = copy.deepcopy(KITTI_ANCHORS)
    cfg["POST_PROCESSING"]["SCORE_THRESH"] = 0.3
    return cfg


def _geometry():
    return types.SimpleNamespace(point_cloud_range=np.asarray(PCR, np.float32), voxel_size=VS,
                                 grid_size=np.asarray(GS), class_names=list(NAMES))


@pytest.fixture(scope="module")
def second3():
    cfg = three_class_second_cfg()
    jcfg = JConfig(cfg)
    jmodel = jgd.GridDetector(model_cfg=jcfg, num_class=3, point_cloud_range=PCR, voxel_size=VS,
                              grid_size=GS, class_names=NAMES)
    run = run_jax(jmodel, jcfg, lambda out, g, c: jgd.grid_detector_loss(out, c, 3),
                  batch=three_class_batch(),
                  post=lambda out: jgd.grid_post_process(out, jcfg.POST_PROCESSING))
    run.cfg = Config(cfg)
    run.port = build_network(run.cfg, 3, device="cpu", dataset=_geometry())
    return run


def test_three_class_second_takes_the_grouped_route_as_jax(second3):
    """A multi-class AnchorHeadSingle config goes through the grouped head
    without a shared conv, with class-major anchors; every weight carried."""
    port = second3.port
    assert port.use_multihead and port.dense_head.shared_conv is None
    assert port.dense_head.head_groups == [NAMES]
    sd = grid_state_dict_from_jax(second3.params, second3.stats0, second3.cfg)
    bridge_covers_every_leaf(sd, port, second3.params, second3.stats0)
    compared = sum(1 for name, p in port.named_parameters() if torch.equal(p.detach(), sd[name]))
    assert compared == len(list(port.parameters()))


def test_three_class_second_matches_jax(second3):
    """Eval outputs within 1e-4 and the final boxes (labels, validity)
    equal JAX's post-processing; train labels exactly, targets within 1e-6,
    every loss within rtol 1e-4."""
    port, cfg = second3.port, second3.cfg
    port.load_state_dict(grid_state_dict_from_jax(second3.params, second3.stats1, cfg))
    port.eval()
    with torch.inference_mode():
        out = port(torch.from_numpy(second3.pts), max_voxels=MAX_VOXELS)
        final = gd.grid_post_process(out, cfg.POST_PROCESSING)
    for key in ("cls_preds", "box_preds", "dir_cls_preds", "batch_box_preds"):
        np.testing.assert_allclose(out[key].numpy(), second3.eval[key], **TOL, err_msg=key)
    np.testing.assert_array_equal(out["anchors"].numpy(), second3.eval["anchors"])
    np.testing.assert_array_equal(final["valid"].numpy(), second3.final["valid"])
    v = final["valid"].numpy()
    assert v.sum() > 0
    np.testing.assert_array_equal(final["labels"].numpy()[v], second3.final["labels"][v])
    np.testing.assert_allclose(final["boxes"].numpy()[v], second3.final["boxes"][v], **TOL)

    port.load_state_dict(grid_state_dict_from_jax(second3.params, second3.stats0, cfg))
    port.train()
    out = port(torch.from_numpy(second3.pts), torch.from_numpy(second3.gt),
               max_voxels=MAX_VOXELS)
    _, metrics = gd.grid_detector_loss(out, cfg, 3)
    labels = out["box_cls_labels"].numpy()
    np.testing.assert_array_equal(labels, second3.out["box_cls_labels"])
    assert set(np.unique(labels)) >= {0, 1, 2, 3}
    np.testing.assert_allclose(out["box_reg_targets"].numpy(), second3.out["box_reg_targets"],
                               rtol=1e-6, atol=1e-6)
    for name, value in metrics.items():
        np.testing.assert_allclose(value.item(), second3.metrics[name], rtol=1e-4, err_msg=name)


def test_three_class_pv_rcnn_stage_one_matches_jax():
    """PV-RCNN keeps one head over a 3-class anchor set (location-major,
    per-anchor thresholds and classes, as JAX's ``single_head_anchor_setup``):
    its stage-1 predictions, labels, targets and anchor losses on JAX's
    train forward."""
    cfg = pvrcnn_model_cfg()
    cfg["DENSE_HEAD"]["ANCHOR_GENERATOR_CONFIG"] = copy.deepcopy(KITTI_ANCHORS)
    jcfg = JConfig(cfg)
    jmodel = jpv.PVRCNN(model_cfg=jcfg, num_class=3, point_cloud_range=PCR, voxel_size=VS,
                        grid_size=GS)
    run = run_jax(jmodel, jcfg, lambda out, g, c: jgd.grid_detector_loss(out, c, 3),
                  forwards=("train",), batch=three_class_batch())
    port = build_network(Config(cfg), 3, device="cpu", dataset=_geometry())
    assert not port.use_multihead and port.anchor_cls is not None
    sd = pvrcnn_state_dict_from_jax(run.params, run.stats0, Config(cfg))
    bridge_covers_every_leaf(sd, port, run.params, run.stats0)
    port.train()
    out = port(torch.from_numpy(run.pts), torch.from_numpy(run.gt), max_voxels=MAX_VOXELS)
    np.testing.assert_array_equal(out["anchors"].numpy(), run.out["anchors"])
    labels = out["box_cls_labels"].numpy()
    np.testing.assert_array_equal(labels, run.out["box_cls_labels"])
    assert set(np.unique(labels)) >= {0, 1, 2, 3}
    np.testing.assert_allclose(out["box_reg_targets"].numpy(), run.out["box_reg_targets"],
                               rtol=1e-6, atol=1e-6)
    for key in ("cls_preds", "box_preds", "dir_cls_preds"):
        np.testing.assert_allclose(out[key].detach().numpy(), run.out[key], **TOL, err_msg=key)
    _, metrics = gd.grid_detector_loss(out, Config(cfg), 3)
    for name, value in metrics.items():
        np.testing.assert_allclose(value.item(), run.metrics[name], rtol=1e-4, err_msg=name)
