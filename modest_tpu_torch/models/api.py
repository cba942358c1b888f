"""Model-family dispatch: forward, loss and post-processing — port of
``modest_tpu/models/api.py`` for the detectors the port has: PointRCNN and
the grid detectors (PointPillar, SECONDNet)."""
from __future__ import annotations

import torch

from .pointrcnn import pointrcnn_loss
from .pointrcnn import post_process as _pointrcnn_post_process

PORTED = ("PointRCNN", "PointPillar", "SECONDNet")


def is_grid_model(model_cfg) -> bool:
    return model_cfg.NAME in ("SECONDNet", "PointPillar")


def _check_ported(model_cfg):
    if model_cfg.NAME not in PORTED:
        raise NotImplementedError(f"modest_tpu_torch ports {', '.join(PORTED)}, "
                                  f"not {model_cfg.NAME}")


def apply_train(model, model_cfg, points, gt_boxes, roi_draws=None, on_stage=None):
    """Train-mode forward of ``model`` (put in train mode) on ``points``
    (B, N, 3+C) and zero-padded ``gt_boxes`` (B, M, 8), with autograd; the
    batch norms update their running statistics as a side effect.
    ``roi_draws`` are PointRCNN's RoI-sampler draws; a grid model draws
    none."""
    _check_ported(model_cfg)
    model.train()
    if is_grid_model(model_cfg):
        return model(points, gt_boxes, on_stage=on_stage)
    return model(points, gt_boxes, roi_draws=roi_draws, on_stage=on_stage)


def compute_loss(out, gt_boxes, model_cfg, num_class: int = 1):
    """(total loss, metrics) of a train-mode forward's outputs."""
    _check_ported(model_cfg)
    if is_grid_model(model_cfg):
        from .grid_detectors import grid_detector_loss

        return grid_detector_loss(out, model_cfg, num_class)
    return pointrcnn_loss(out, gt_boxes, model_cfg, num_class)


def apply_eval(model, model_cfg, points, on_stage=None):
    """Eval forward of ``model`` (put in eval mode) on ``points`` (B, N, 3+C),
    without autograd."""
    _check_ported(model_cfg)
    model.eval()
    with torch.inference_mode():
        return model(points, on_stage=on_stage)


def post_process(out, model_cfg):
    _check_ported(model_cfg)
    with torch.inference_mode():
        if is_grid_model(model_cfg):
            from .grid_detectors import grid_post_process

            return grid_post_process(out, model_cfg.POST_PROCESSING)
        final = _pointrcnn_post_process(out, model_cfg.POST_PROCESSING)
    final["rois"] = out.get("rois")
    return final
