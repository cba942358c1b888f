"""Voxel R-CNN in modest_tpu_torch against the JAX package: the tiny config
of tests/test_voxel_rcnn.py (copied below, on the tiny SECOND of
tests/test_torch_grid_detectors.py), JAX's variables (seeded, from
``jax.eval_shape`` of its init) carried over by
``models/convert.py::voxelrcnn_state_dict_from_jax``, the same toy batch.
One JAX train forward (its RoI sampler's key recorded and handed to the
port as draws) and one eval forward are shared by the module. Also the
voxel query alone (indices and empty flags equal), the backbone's scale
shapes, the build_network route and the shipped config dict against its
YAML."""
from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modest_tpu.models import sparse_conv as jsc
from modest_tpu.models import voxel_rcnn as jvr
from modest_tpu.ops import pointnet2_stack as jstack
from modest_tpu_torch.models import api, build_network
from modest_tpu_torch.models import sparse_conv as sc
from modest_tpu_torch.models import voxel_rcnn as vr
from modest_tpu_torch.models.convert import voxelrcnn_state_dict_from_jax
from modest_tpu_torch.ops import pointnet2_stack as stack
from modest_tpu_torch.utils.config import Config
from tests.test_torch_grid_detectors import geometry, second_model_cfg
from tests.test_torch_losses import jax_draws
from tests.torch_detector_pair import (MAX_VOXELS, bridge_covers_every_leaf, jax_model,
                                       port_model, run_jax)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = {"rtol": 1e-4, "atol": 1e-4}
YAML = "configs/models/lyft_models/voxel_rcnn_dynamic_obj.yaml"


def voxelrcnn_model_cfg():
    cfg = second_model_cfg()
    cfg["NAME"] = "VoxelRCNN"
    cfg["ROI_HEAD"] = {
        "NAME": "VoxelRCNNHead", "CLASS_AGNOSTIC": True,
        "SHARED_FC": [32], "CLS_FC": [16], "REG_FC": [16], "DP_RATIO": 0.0,
        "NMS_CONFIG": {
            "TRAIN": {"NMS_TYPE": "nms_gpu", "MULTI_CLASSES_NMS": False,
                      "NMS_PRE_MAXSIZE": 128, "NMS_POST_MAXSIZE": 32, "NMS_THRESH": 0.8},
            "TEST": {"NMS_TYPE": "nms_gpu", "MULTI_CLASSES_NMS": False,
                     "NMS_PRE_MAXSIZE": 128, "NMS_POST_MAXSIZE": 16, "NMS_THRESH": 0.7},
        },
        "ROI_GRID_POOL": {
            "GRID_SIZE": 3,
            "FEATURES_SOURCE": ["x_conv2", "x_conv3"],
            "POOL_LAYERS": {
                "x_conv2": {"MLPS": [[8, 8]], "QUERY_RANGES": [[2, 2, 2]], "POOL_RADIUS": [1.0],
                            "NSAMPLE": [8], "POOL_METHOD": "max_pool"},
                "x_conv3": {"MLPS": [[8, 8]], "QUERY_RANGES": [[2, 2, 2]], "POOL_RADIUS": [2.0],
                            "NSAMPLE": [8], "POOL_METHOD": "max_pool"},
            },
        },
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
    cfg = voxelrcnn_model_cfg()
    run = run_jax(jax_model(jvr.VoxelRCNN, cfg), Config(cfg), jvr.voxelrcnn_loss, jvr)
    run.cfg, run.port = Config(cfg), port_model(cfg)
    return run


def _load(pair, stats):
    pair.port.load_state_dict(voxelrcnn_state_dict_from_jax(pair.params, stats, pair.cfg))


def _voxel_set(rng, b, shape_zyx, n_active, v):
    """Sorted keys (padding past every cell) and centres of random active
    voxels, as a backbone scale holds them."""
    nz, ny, nx = shape_zyx
    keys = np.full((b, v), nz * ny * nx, np.int64)
    for i in range(b):
        keys[i, :n_active] = np.sort(rng.choice(nz * ny * nx, n_active, replace=False))
    coords = np.stack([keys // (ny * nx), (keys // nx) % ny, keys % nx], -1)
    return keys, coords


@pytest.mark.parametrize("radius,nsample,max_range", [(1.0, 8, 2), (2.0, 16, 4), (0.4, 4, 1)])
def test_voxel_query_matches_jax(radius, nsample, max_range):
    """Indices and empty flags equal to JAX's voxel_query on one scale of a
    random active set: queries in dense and empty regions, near the grid's
    edges and outside it, balls with fewer hits than ``nsample``."""
    rng = np.random.RandomState(int(radius * 10) + nsample)
    shape = (9, 16, 16)
    vs, pcr = (1.0, 1.0, 0.5), (0.0, -8.0, -3.0, 16.0, 8.0, 1.5)
    keys, coords = _voxel_set(rng, 2, shape, 300, 400)
    centres = ((coords[..., ::-1] + 0.5) * vs + pcr[:3]).astype(np.float32)
    queries = rng.uniform([-1, -9, -3.5], [17, 9, 2], (2, 150, 3)).astype(np.float32)
    queries[:, :40] = centres[:, :40] + rng.normal(0, 0.3, (2, 40, 3)).astype(np.float32)
    idx, empty = stack.voxel_query(torch.from_numpy(queries), torch.from_numpy(keys),
                                   torch.from_numpy(centres), radius, nsample, max_range, shape,
                                   pcr, vs)
    nz, ny, nx = shape
    jidx, jempty = jstack.voxel_query(
        jnp.asarray(queries), jnp.full((2,), 150, jnp.int32), jnp.asarray(keys.astype(np.int32)),
        jnp.asarray(keys < nz * ny * nx), jnp.asarray(centres), radius, nsample, max_range, nx,
        ny, nz, point_cloud_range=pcr, voxel_size=vs)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(empty.numpy(), np.asarray(jempty))
    assert empty.any() and not empty.all()
    assert (~empty).sum() > 40


def test_voxel_query_chunks_agree():
    """Queries in chunks give the indices of one pass."""
    rng = np.random.RandomState(7)
    shape = (9, 16, 16)
    vs, pcr = (1.0, 1.0, 0.5), (0.0, -8.0, -3.0)
    keys, coords = _voxel_set(rng, 1, shape, 500, 500)
    centres = torch.from_numpy(((coords[..., ::-1] + 0.5) * vs + pcr).astype(np.float32))
    queries = torch.from_numpy(rng.uniform([0, -8, -3], [16, 8, 1.5], (1, 300, 3)).astype(
        np.float32))
    args = (queries, torch.from_numpy(keys), centres, 1.5, 8, 2, shape, pcr, vs)
    whole = stack.voxel_query(*args)
    chunk = stack.VOXEL_QUERY_CHUNK
    try:
        stack.VOXEL_QUERY_CHUNK = 64
        parts = stack.voxel_query(*args)
    finally:
        stack.VOXEL_QUERY_CHUNK = chunk
    for a, b in zip(whole, parts):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_backbone_scale_shapes_match_jax():
    for gs in ((32, 32, 32), (1808, 1600, 40), (17, 9, 5)):
        assert sc.backbone_scale_shapes(gs) == jsc.backbone_scale_shapes(gs)


def test_bridge_covers_every_leaf(pair):
    sd = voxelrcnn_state_dict_from_jax(pair.params, pair.stats0, pair.cfg)
    bridge_covers_every_leaf(sd, pair.port, pair.params, pair.stats0)


def test_eval_forward_and_boxes_match_jax(pair):
    """The RoIs and their validity, the RCNN logits within 1e-4 and its box
    residuals and refined boxes within 2e-3, the final boxes 1:1 with the
    post-processing of JAX's outputs."""
    _load(pair, pair.stats1)
    pair.port.eval()
    with torch.inference_mode():
        out = pair.port(torch.from_numpy(pair.pts), max_voxels=MAX_VOXELS)
    want = pair.eval
    np.testing.assert_array_equal(out["roi_valid"].numpy(), want["roi_valid"])
    assert out["roi_valid"].any()
    np.testing.assert_allclose(out["rois"].numpy(), want["rois"], **TOL)
    np.testing.assert_allclose(out["rcnn_cls"].numpy(), want["rcnn_cls"], **TOL)
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


def test_train_forward_and_loss_match_jax(pair):
    """The train forward with JAX's sampler draws: anchor labels and the
    sampled RoIs equal, the RCNN outputs within 1e-4, every loss term within
    rtol 1e-3, the running statistics it leaves, finite gradients."""
    from modest_tpu_torch.train.state import step_roi_draws

    _load(pair, pair.stats0)
    tcfg = pair.cfg.ROI_HEAD
    draws = jax_draws(pair.key, 2, int(tcfg.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE),
                      int(tcfg.TARGET_CONFIG.ROI_PER_IMAGE))
    assert {k: v.shape for k, v in step_roi_draws(pair.cfg, 2, 0, 666, "cpu").items()} == {
        k: v.shape for k, v in draws.items()}
    gt = torch.from_numpy(pair.gt)
    pair.port.train()
    out = pair.port(torch.from_numpy(pair.pts), gt, roi_draws=draws, max_voxels=MAX_VOXELS)
    loss, metrics = api.compute_loss(out, gt, pair.cfg, 1)
    np.testing.assert_array_equal(out["box_cls_labels"].numpy(), pair.out["box_cls_labels"])
    for key in ("rois", "gt_of_rois", "rcnn_cls_labels", "reg_valid_mask"):
        np.testing.assert_allclose(out["roi_targets"][key].numpy(),
                                   pair.out["roi_targets"][key], **TOL, err_msg=key)
    for key in ("rcnn_cls", "rcnn_reg"):
        np.testing.assert_allclose(out[key].detach().numpy(), pair.out[key], **TOL, err_msg=key)
    assert set(metrics) == set(pair.metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(v.item(), pair.metrics[k], rtol=1e-3, err_msg=k)
    assert pair.metrics["rcnn_loss_cls"] > 0
    loss.backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in pair.port.parameters())
    own = pair.port.state_dict()
    want = voxelrcnn_state_dict_from_jax(pair.params, pair.stats1, pair.cfg)
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) >= 30
    for k in stats:
        np.testing.assert_allclose(own[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    pair.port.eval()


def test_build_network_routes_voxel_rcnn():
    cfg = Config(voxelrcnn_model_cfg())
    model = build_network(cfg, 1, device="cpu", dataset=geometry("second"))
    assert isinstance(model, vr.VoxelRCNN) and model.backbone_3d.return_multiscale
    assert list(model.grid_pools) == ["x_conv2", "x_conv3"]
    assert api.samples_rois(cfg)
    bad = voxelrcnn_model_cfg()
    bad["BACKBONE_3D"] = {"NAME": "VoxelResBackBone8x"}
    with pytest.raises(NotImplementedError):
        build_network(Config(bad), 1, device="cpu", dataset=geometry("second"))


@pytest.mark.parametrize("section", ["CLASS_NAMES", "DATA_CONFIG", "MODEL", "OPTIMIZATION"])
def test_voxel_rcnn_dict_equals_the_jax_loaders_yaml(section):
    from modest_tpu.utils.config import cfg_from_yaml_file
    from modest_tpu_torch import configs

    want = cfg_from_yaml_file(YAML).to_dict()
    full = configs.VOXEL_RCNN_DYNAMIC_OBJ_FULL
    assert list(want) == list(full)
    assert json.dumps(full[section]) == json.dumps(want[section])
    assert configs.SHIPPED_MODEL_CONFIGS[YAML] is full
