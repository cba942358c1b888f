"""Model-family dispatch: forward, loss and post-processing — port of
``modest_tpu/models/api.py`` for the detectors the port has: PointRCNN, the
grid detectors (PointPillar, SECONDNet, single or grouped anchor head),
PVRCNN, SECONDNetIoU, VoxelRCNN, PartA2 and the anchor-free Part-A2 (NAME
PointRCNN with the UNetV2 backbone). The two-stage heads share the
refined-box post-processing (SECOND-IoU's "refined" boxes are its RoIs,
scored by its IoU branch)."""
from __future__ import annotations

import torch

from .pointrcnn import pointrcnn_loss
from .pointrcnn import post_process as _pointrcnn_post_process

PORTED = ("PointRCNN", "PointPillar", "SECONDNet", "PVRCNN", "SECONDNetIoU", "SECONDIoU",
          "VoxelRCNN", "PartA2", "PartA2Net")
# the detectors whose train forward samples RoIs (and takes ``roi_draws``)
SAMPLES_ROIS = ("PointRCNN", "PVRCNN", "VoxelRCNN", "PartA2", "PartA2Net")


def is_grid_model(model_cfg) -> bool:
    return model_cfg.NAME in ("SECONDNet", "PointPillar")


def is_parta2_free(model_cfg) -> bool:
    return (model_cfg.NAME == "PointRCNN"
            and model_cfg.get("BACKBONE_3D", {}).get("NAME", "") == "UNetV2")


def samples_rois(model_cfg) -> bool:
    return model_cfg.NAME in SAMPLES_ROIS


def _check_ported(model_cfg):
    if model_cfg.NAME not in PORTED:
        raise NotImplementedError(f"modest_tpu_torch ports {', '.join(PORTED)}, "
                                  f"not {model_cfg.NAME}")


def apply_train(model, model_cfg, points, gt_boxes, roi_draws=None, on_stage=None):
    """Train-mode forward of ``model`` (put in train mode) on ``points``
    (B, N, 3+C) and zero-padded ``gt_boxes`` (B, M, 8), with autograd; the
    batch norms update their running statistics as a side effect.
    ``roi_draws`` are the RoI sampler's draws of the detectors that sample
    RoIs (``SAMPLES_ROIS``); the others draw none."""
    _check_ported(model_cfg)
    model.train()
    if not samples_rois(model_cfg):
        return model(points, gt_boxes, on_stage=on_stage)
    return model(points, gt_boxes, roi_draws=roi_draws, on_stage=on_stage)


def compute_loss(out, gt_boxes, model_cfg, num_class: int = 1):
    """(total loss, metrics) of a train-mode forward's outputs."""
    _check_ported(model_cfg)
    if is_parta2_free(model_cfg):
        from .part_a2 import parta2_free_loss

        return parta2_free_loss(out, gt_boxes, model_cfg, num_class)
    if is_grid_model(model_cfg):
        from .grid_detectors import grid_detector_loss

        return grid_detector_loss(out, model_cfg, num_class)
    if model_cfg.NAME == "PVRCNN":
        from .pv_rcnn import pvrcnn_loss

        return pvrcnn_loss(out, gt_boxes, model_cfg, num_class)
    if model_cfg.NAME == "VoxelRCNN":
        from .voxel_rcnn import voxelrcnn_loss

        return voxelrcnn_loss(out, gt_boxes, model_cfg, num_class)
    if model_cfg.NAME in ("PartA2", "PartA2Net"):
        from .part_a2 import parta2_loss

        return parta2_loss(out, gt_boxes, model_cfg, num_class)
    if model_cfg.NAME in ("SECONDNetIoU", "SECONDIoU"):
        from .second_iou import second_iou_loss

        return second_iou_loss(out, gt_boxes, model_cfg, num_class)
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
