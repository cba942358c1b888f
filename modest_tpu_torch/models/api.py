"""Model-family dispatch: forward, loss and post-processing — port of
``modest_tpu/models/api.py`` (PointRCNN only so far)."""
from __future__ import annotations

import torch

from .pointrcnn import pointrcnn_loss
from .pointrcnn import post_process as _pointrcnn_post_process


def _check_pointrcnn(model_cfg):
    if model_cfg.NAME != "PointRCNN":
        raise NotImplementedError(f"modest_tpu_torch ports only PointRCNN, not {model_cfg.NAME}")


def apply_train(model, model_cfg, points, gt_boxes, roi_draws=None, on_stage=None):
    """Train-mode forward of ``model`` (put in train mode) on ``points``
    (B, N, 3+C) and zero-padded ``gt_boxes`` (B, M, 8), with autograd; the
    batch norms update their running statistics as a side effect."""
    _check_pointrcnn(model_cfg)
    model.train()
    return model(points, gt_boxes, roi_draws=roi_draws, on_stage=on_stage)


def compute_loss(out, gt_boxes, model_cfg, num_class: int = 1):
    """(total loss, metrics) of a train-mode forward's outputs."""
    _check_pointrcnn(model_cfg)
    return pointrcnn_loss(out, gt_boxes, model_cfg, num_class)


def apply_eval(model, model_cfg, points, on_stage=None):
    """Eval forward of ``model`` (put in eval mode) on ``points`` (B, N, 3+C),
    without autograd."""
    _check_pointrcnn(model_cfg)
    model.eval()
    with torch.inference_mode():
        return model(points, on_stage=on_stage)


def post_process(out, model_cfg):
    _check_pointrcnn(model_cfg)
    with torch.inference_mode():
        final = _pointrcnn_post_process(out, model_cfg.POST_PROCESSING)
    final["rois"] = out.get("rois")
    return final
