"""The grouped anchor head in modest_tpu_torch against the JAX package, whole:
``TINY_MULTIHEAD`` of tests/test_nuscenes_waymo.py (PointPillars, two groups,
the 9-code (cos, sin) coder with velocity, multi-class NMS) and a tiny CBGS
SECOND (``VoxelResBackBone8x``, three classes in two groups, a middle conv
per branch). JAX's variables (seeded, from ``jax.eval_shape`` of its init)
are carried over by ``models/convert.py::grid_state_dict_from_jax``; one JAX
train forward + loss and one eval forward + post-processing per model are
shared by the module. No JAX gradient is taken."""
from __future__ import annotations

import copy
import types

import jax
import numpy as np
import pytest
import torch

from modest_tpu.models import grid_detectors as jgd
from modest_tpu.utils.config import Config as JConfig
from modest_tpu_torch.models import api, build_network
from modest_tpu_torch.models import grid_detectors as gd
from modest_tpu_torch.models.anchor_head_multi import AnchorHeadMulti
from modest_tpu_torch.models.convert import grid_state_dict_from_jax
from modest_tpu_torch.models.sparse_conv import VoxelResBackBone8x
from modest_tpu_torch.utils.config import Config
from tests.test_nuscenes_waymo import TINY_MULTIHEAD
from tests.test_torch_grid_detectors import GEOMETRY, PCR
from tests.torch_detector_pair import MAX_VOXELS, bridge_covers_every_leaf, run_jax
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = {"rtol": 1e-4, "atol": 1e-4}


def cbgs_second_cfg():
    """A narrow ``cbgs_second_multihead``: the residual sparse backbone, a
    shared conv, one middle conv per branch, groups {car} and {truck,
    pedestrian}, the 9-code coder, multi-class NMS."""
    cfg = copy.deepcopy(TINY_MULTIHEAD)
    cfg["NAME"] = "SECONDNet"
    cfg["VFE"] = {"NAME": "MeanVFE"}
    cfg["BACKBONE_3D"] = {"NAME": "VoxelResBackBone8x"}
    cfg["MAP_TO_BEV"] = {"NAME": "HeightCompression", "NUM_BEV_FEATURES": 256}
    cfg["BACKBONE_2D"] = {"NAME": "BaseBEVBackbone", "LAYER_NUMS": [1], "LAYER_STRIDES": [1],
                          "NUM_FILTERS": [32], "UPSAMPLE_STRIDES": [1],
                          "NUM_UPSAMPLE_FILTERS": [32]}
    head = cfg["DENSE_HEAD"]
    head.update(SHARED_CONV_NUM_FILTER=16, NUM_MIDDLE_CONV=1, NUM_MIDDLE_FILTER=8)
    car, ped = head["ANCHOR_GENERATOR_CONFIG"]
    truck = {**car, "class_name": "truck", "anchor_sizes": [[6.9, 2.5, 2.8]],
             "matched_threshold": 0.55, "unmatched_threshold": 0.4}
    head["ANCHOR_GENERATOR_CONFIG"] = [
        {**c, "feature_map_stride": 8, "anchor_bottom_heights": [-1.6]}
        for c in (car, truck, ped)]
    head["RPN_HEAD_CFGS"] = [{"HEAD_CLS_NAME": ["car"]},
                             {"HEAD_CLS_NAME": ["truck", "pedestrian"]}]
    return cfg


def _batch(which):
    """Two 5-feature scans and (B, 4, 10) gt boxes (velocity, then class)."""
    rng = np.random.RandomState(0)
    gt = np.zeros((2, 4, 10), np.float32)
    if which == "pillar":
        pts = rng.uniform(-15, 15, (2, 256, 5)).astype(np.float32)
        gx = -16 + (32 / 15) * 5  # on an anchor centre (see test_nuscenes_waymo.py)
        gt[:, 0] = [2, 3, -1, 4.6, 2.0, 1.7, 0.2, 1.5, -0.5, 1]
        gt[:, 1] = [gx, gx, -1, 0.7, 0.7, 1.7, 0.0, 0.1, 0.2, 2]
        return pts, gt
    pts = rng.uniform(0, 1, (2, 512, 5)).astype(np.float32)
    pts[..., 0] *= 16
    pts[..., 1] = (pts[..., 1] - 0.5) * 16
    pts[..., 2] = pts[..., 2] * 4 - 3
    x, y = GEOMETRY["second"][2]  # a stride-8 anchor site
    gt[:, 0] = [x, y, -0.75, 4.6, 2.0, 1.7, 0.0, 2.0, 0.5, 1]
    gt[1, 1] = [x + 5.3, y + 2.7, -0.4, 6.9, 2.5, 2.8, 1.5, -1.0, 0.0, 2]
    gt[1, 2] = [x - 16 / 3, y, -0.75, 0.7, 0.7, 1.7, 0.3, 0.0, 0.0, 3]
    return pts, gt


CASES = {
    "pillar": (TINY_MULTIHEAD, (-16.0, -16.0, -5.0, 16.0, 16.0, 3.0), (1.0, 1.0, 8.0),
               (32, 32, 1), ("car", "pedestrian")),
    "cbgs_second": (cbgs_second_cfg(), tuple(PCR), tuple(GEOMETRY["second"][0]),
                    GEOMETRY["second"][1], ("car", "truck", "pedestrian")),
}


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    cfg_dict, pcr, vs, gs, names = CASES[request.param]
    jcfg = JConfig(cfg_dict)
    num_class = len(names)
    jmodel = jgd.GridDetector(model_cfg=jcfg, num_class=num_class, point_cloud_range=pcr,
                              voxel_size=vs, grid_size=gs, class_names=names)
    run = run_jax(jmodel, jcfg, lambda out, g, c: jgd.grid_detector_loss(out, c, num_class),
                  batch=_batch(request.param),
                  post=lambda out: jgd.grid_post_process(out, jcfg.POST_PROCESSING))
    dataset = types.SimpleNamespace(point_cloud_range=pcr, voxel_size=vs, grid_size=gs,
                                    class_names=list(names), num_point_features=5)
    run.cfg, run.num_class = Config(cfg_dict), num_class
    run.port = build_network(run.cfg, num_class, device="cpu", dataset=dataset)
    return run


def _load(pair, stats):
    pair.port.load_state_dict(grid_state_dict_from_jax(pair.params, stats, pair.cfg))


def test_routes_to_the_grouped_head(pair):
    port = pair.port
    assert isinstance(port.dense_head, AnchorHeadMulti) and port.use_multihead
    assert port.box_coder.code_size == 10
    if pair.cfg.NAME == "SECONDNet":
        assert isinstance(port.backbone_3d, VoxelResBackBone8x)
        assert len(port.dense_head.rpn_heads[0].cls_mid) == 3  # conv, BN, ReLU


def test_bridge_covers_every_leaf(pair):
    sd = grid_state_dict_from_jax(pair.params, pair.stats0, pair.cfg)
    bridge_covers_every_leaf(sd, pair.port, pair.params, pair.stats0)
    compared = sum(1 for name, p in pair.port.named_parameters()
                   if torch.equal(p.detach(), sd[name]))
    assert compared == len(list(pair.port.parameters()))


def test_eval_outputs_and_multi_class_nms_match_jax(pair):
    """The head's logits and residuals, the anchors, the 9-column decoded
    boxes within 1e-4; the multi-class NMS's kept slots and labels equal
    JAX's, their boxes and scores within 1e-4."""
    _load(pair, pair.stats1)
    pair.port.eval()
    with torch.inference_mode():
        out = pair.port(torch.from_numpy(pair.pts), max_voxels=MAX_VOXELS)
    want = pair.eval
    np.testing.assert_array_equal(out["anchors"].numpy(), want["anchors"])
    np.testing.assert_array_equal(out["anchor_cls"].numpy(), want["anchor_cls"])
    assert out["batch_box_preds"].shape[-1] == 9 and out["box_preds"].shape[-1] == 10
    for key in ("cls_preds", "box_preds", "dir_cls_preds", "batch_cls_preds",
                "batch_box_preds"):
        np.testing.assert_allclose(out[key].numpy(), want[key], **TOL, err_msg=key)
    final = api.post_process(out, pair.cfg)
    ref = pair.final
    k = int(pair.cfg.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE)
    assert final["boxes"].shape == (2, pair.num_class * k, 9)
    np.testing.assert_array_equal(final["valid"].numpy(), ref["valid"])
    np.testing.assert_array_equal(final["labels"].numpy(), ref["labels"])
    v = final["valid"].numpy()
    assert v.sum() > 0
    np.testing.assert_allclose(final["boxes"].numpy()[v], ref["boxes"][v], **TOL)
    np.testing.assert_allclose(final["scores"].numpy(), ref["scores"], **TOL)


def test_train_targets_losses_and_statistics_match_jax(pair):
    """Labels exactly; the 10-column targets and the matched headings within
    1e-6; the predictions within 1e-4; every loss within rtol 1e-4; the
    running statistics the forward left within 1e-5."""
    _load(pair, pair.stats0)
    pair.port.train()
    out = pair.port(torch.from_numpy(pair.pts), torch.from_numpy(pair.gt), max_voxels=MAX_VOXELS)
    _, metrics = api.compute_loss(out, None, pair.cfg, pair.num_class)
    want = pair.out
    labels = out["box_cls_labels"].numpy()
    np.testing.assert_array_equal(labels, want["box_cls_labels"])
    assert (labels == 1).any() and (labels == pair.num_class).any()
    for key in ("box_reg_targets", "box_gt_heading"):
        np.testing.assert_allclose(out[key].numpy(), want[key], rtol=1e-6, atol=1e-6,
                                   err_msg=key)
    for key in ("cls_preds", "box_preds", "dir_cls_preds"):
        np.testing.assert_allclose(out[key].detach().numpy(), want[key], **TOL, err_msg=key)
    for name, value in metrics.items():
        np.testing.assert_allclose(value.item(), pair.metrics[name], rtol=1e-4, err_msg=name)
    stats = grid_state_dict_from_jax(pair.params, pair.stats1, pair.cfg)
    own = pair.port.state_dict()
    checked = 0
    for name, value in stats.items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(own[name].numpy(), value.numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=name)
            checked += 1
    assert checked >= 8


def test_grouped_head_needs_class_names():
    cfg_dict, pcr, vs, gs, _ = CASES["pillar"]
    dataset = types.SimpleNamespace(point_cloud_range=pcr, voxel_size=vs, grid_size=gs)
    with pytest.raises(ValueError, match="class_names"):
        build_network(Config(cfg_dict), 2, device="cpu", dataset=dataset)


def test_loss_on_jax_outputs_matches_jax(pair):
    """``grid_detector_loss`` alone on JAX's train outputs: no sin trick for
    the (cos, sin) coder, the direction targets from the matched heading."""
    out = {k: torch.from_numpy(np.array(v)) for k, v in pair.out.items()
           if k != "box_coder_sincos"}
    out["box_coder_sincos"] = True
    _, metrics = gd.grid_detector_loss(out, pair.cfg, pair.num_class)
    _, want = jax.jit(lambda o: jgd.grid_detector_loss({**o, "box_coder_sincos": True},
                                                       pair.cfg, pair.num_class))(
        {k: v for k, v in pair.out.items() if k != "box_coder_sincos"})
    for name, value in metrics.items():
        np.testing.assert_allclose(float(value), float(want[name]), rtol=1e-5, err_msg=name)
