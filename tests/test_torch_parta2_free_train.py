"""The anchor-free Part-A2's train forward in modest_tpu_torch against the
JAX package: the tiny 3-class config and seeded variables of
tests/test_torch_parta2_free.py, one jitted JAX train forward + loss (its
RoI sampler's key recorded and handed to the port as draws) shared by the
module: targets, heads, losses and the running statistics it leaves. No
JAX gradient is taken."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from modest_tpu.models import part_a2 as jpa
from modest_tpu_torch.models import api, build_network
from modest_tpu_torch.models.convert import parta2_free_state_dict_from_jax
from modest_tpu_torch.utils.config import Config
from tests.test_torch_grid_detectors import PCR
from tests.test_torch_losses import jax_draws
from tests.test_torch_multiclass import GS, VS, three_class_batch
from tests.test_torch_multiclass_models import _geometry
from tests.test_torch_parta2_free import TOL, parta2_free_model_cfg
from tests.torch_detector_pair import MAX_VOXELS, run_jax
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def pair():
    cfg = Config(parta2_free_model_cfg())
    jmodel = jpa.PartA2Free(model_cfg=cfg, num_class=3, point_cloud_range=PCR, voxel_size=VS,
                            grid_size=GS)
    run = run_jax(jmodel, cfg, lambda out, g, c: jpa.parta2_free_loss(out, g, c, 3), jpa,
                  forwards=("train",), batch=three_class_batch())
    run.cfg = cfg
    run.port = build_network(cfg, 3, device="cpu", dataset=_geometry())
    return run


def _load(pair, stats):
    pair.port.load_state_dict(parta2_free_state_dict_from_jax(pair.params, stats, pair.cfg))


def test_train_forward_and_losses_match_jax(pair):
    """With JAX's sampler draws: the point labels, the segmentation targets
    and the sampled RoIs' labels equal, the box and part targets and the
    heads within 1e-4, every loss within rtol 1e-4; the running statistics
    the forward left, finite gradients."""
    _load(pair, pair.stats0)
    tcfg = pair.cfg.ROI_HEAD
    draws = jax_draws(pair.key, 2, int(tcfg.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE),
                      int(tcfg.TARGET_CONFIG.ROI_PER_IMAGE))
    gt = torch.from_numpy(pair.gt)
    pair.port.train()
    out = pair.port(torch.from_numpy(pair.pts), gt, roi_draws=draws, max_voxels=MAX_VOXELS)
    loss, metrics = api.compute_loss(out, gt, pair.cfg, 3)
    want = pair.out
    for key in ("point_cls_labels", "seg_targets", "roi_labels"):
        np.testing.assert_array_equal(out[key].numpy(), want[key], err_msg=key)
    assert set(np.unique(want["point_cls_labels"])) >= {-1, 0, 1}
    assert (want["point_cls_labels"] > 1).any()
    for key in ("point_box_labels", "part_targets", "point_cls_preds", "point_box_preds",
                "part_reg", "rois", "rcnn_cls", "rcnn_reg"):
        np.testing.assert_allclose(out[key].detach().numpy(), want[key], **TOL, err_msg=key)
    for key in ("gt_of_rois", "rcnn_cls_labels", "reg_valid_mask"):
        np.testing.assert_allclose(out["roi_targets"][key].numpy(), want["roi_targets"][key],
                                   **TOL, err_msg=key)
    assert set(metrics) == set(pair.metrics)
    for name, value in metrics.items():
        np.testing.assert_allclose(value.item(), pair.metrics[name], rtol=1e-4, err_msg=name)
    assert pair.metrics["part_loss"] > 0 and pair.metrics["point_loss_box"] > 0
    loss.backward()
    # the UNet's BEV output (conv_out) feeds no RPN here, so it takes no gradient
    for name, p in pair.port.named_parameters():
        assert (p.grad is None) == name.startswith("backbone_3d.conv_out."), name
        assert p.grad is None or bool(torch.isfinite(p.grad).all()), name
    own = pair.port.state_dict()
    stats = parta2_free_state_dict_from_jax(pair.params, pair.stats1, pair.cfg)
    checked = [k for k in stats if k.endswith(("running_mean", "running_var"))]
    assert len(checked) >= 40
    for k in checked:
        np.testing.assert_allclose(own[k].numpy(), stats[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
