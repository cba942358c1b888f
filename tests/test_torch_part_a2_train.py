"""Part-A2's train forward in modest_tpu_torch against the JAX package: the
tiny config and seeded variables of tests/test_torch_part_a2.py, one jitted
JAX train forward (its RoI sampler's key recorded and handed to the port as
draws) shared by the module: targets, heads, losses and the running
statistics it leaves."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from modest_tpu.models import part_a2 as jpa
from modest_tpu_torch.models import api
from modest_tpu_torch.models.convert import parta2_state_dict_from_jax
from modest_tpu_torch.utils.config import Config
from tests.test_torch_losses import jax_draws
from tests.test_torch_part_a2 import parta2_model_cfg
from tests.torch_detector_pair import MAX_VOXELS, jax_model, port_model, run_jax
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = {"rtol": 1e-4, "atol": 1e-4}


@pytest.fixture(scope="module")
def pair():
    cfg = parta2_model_cfg()
    run = run_jax(jax_model(jpa.PartA2, cfg), Config(cfg), jpa.parta2_loss, jpa,
                  forwards=("train",))
    run.cfg, run.port = Config(cfg), port_model(cfg)
    return run


def _load(pair, stats):
    pair.port.load_state_dict(parta2_state_dict_from_jax(pair.params, stats, pair.cfg))


def test_train_forward_and_loss_match_jax(pair):
    """The train forward with JAX's sampler draws: anchor labels, the part
    targets and the sampled RoIs equal, the heads within 1e-4, every loss
    term within rtol 1e-3, the running statistics it leaves, finite
    gradients."""
    _load(pair, pair.stats0)
    tcfg = pair.cfg.ROI_HEAD
    draws = jax_draws(pair.key, 2, int(tcfg.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE),
                      int(tcfg.TARGET_CONFIG.ROI_PER_IMAGE))
    gt = torch.from_numpy(pair.gt)
    pair.port.train()
    out = pair.port(torch.from_numpy(pair.pts), gt, roi_draws=draws, max_voxels=MAX_VOXELS)
    loss, metrics = api.compute_loss(out, gt, pair.cfg, 1)
    np.testing.assert_array_equal(out["box_cls_labels"].numpy(), pair.out["box_cls_labels"])
    np.testing.assert_array_equal(out["seg_targets"].numpy(), pair.out["seg_targets"])
    assert pair.out["seg_targets"].sum() > 0
    np.testing.assert_allclose(out["part_targets"].numpy(), pair.out["part_targets"], **TOL)
    for key in ("rois", "gt_of_rois", "rcnn_cls_labels", "reg_valid_mask"):
        np.testing.assert_allclose(out["roi_targets"][key].numpy(),
                                   pair.out["roi_targets"][key], **TOL, err_msg=key)
    for key in ("seg_logits", "part_reg", "rcnn_cls", "rcnn_reg"):
        np.testing.assert_allclose(out[key].detach().numpy(), pair.out[key], **TOL, err_msg=key)
    assert set(metrics) == set(pair.metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(v.item(), pair.metrics[k], rtol=1e-3, err_msg=k)
    assert pair.metrics["seg_loss"] > 0 and pair.metrics["part_loss"] > 0
    loss.backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in pair.port.parameters())
    own = pair.port.state_dict()
    want = parta2_state_dict_from_jax(pair.params, pair.stats1, pair.cfg)
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) >= 40
    for k in stats:
        np.testing.assert_allclose(own[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    pair.port.eval()
