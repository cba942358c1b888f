"""SECOND-IoU — port of ``modest_tpu/models/second_iou.py`` (reference pcdet
detectors/second_net_iou.py, roi_heads/second_head.py).

SECOND's stage 1 and its proposals, then an IoU branch: each proposal
samples the BEV map on a rotated G × G grid (bilinear), a shared MLP and a
max over the grid pool it, and a head predicts the proposal's 3-D IoU with
the ground truth. In eval the calibrated IoU logit is the score that the
refined-box post-processing ranks the proposals by (the RoIs are the boxes).
The training targets are the proposals' best 3-D IoU with a gt box; the
head draws no RoIs. Module names follow the JAX package's (``iou_mlp``,
``iou_head``); stage 1 keeps pcdet's.
"""
from __future__ import annotations

import torch

from ..ops.iou3d import boxes_iou3d
from ..parallel.mesh import global_mean
from .grid_detectors import MAX_VOXELS, TwoStageGridDetector, grid_detector_loss
from .layers import FCHead, SharedMLP
from .losses import sigmoid_ce_with_logits
from .pv_rcnn import bilinear_bev


def roi_bev_grid(rois, g: int):
    """(B, R, 7) RoIs → (B, R, g², 2): the centres of a g × g grid over each
    RoI's BEV rectangle, rotated by its heading, cell (i, j) at row i·g + j."""
    ar = torch.arange(g, device=rois.device)
    idx = torch.stack(torch.meshgrid(ar, ar, indexing="ij"), dim=-1).reshape(-1, 2)
    frac = (idx.to(torch.float32) + 0.5) / g - 0.5
    local = frac[None, None] * rois[:, :, None, 3:5]  # (B, R, g², 2)
    c, s = torch.cos(rois[..., 6])[..., None], torch.sin(rois[..., 6])[..., None]
    gx = local[..., 0] * c - local[..., 1] * s
    gy = local[..., 0] * s + local[..., 1] * c
    return torch.stack([gx, gy], dim=-1) + rois[:, :, None, :2]


class SECONDIoU(TwoStageGridDetector):
    """SECOND-IoU with one anchor head: ``model.train()`` adds the anchor and
    IoU targets, ``model.eval()`` gives the IoU logits and the RoIs to
    ``pointrcnn.post_process``."""

    def __init__(self, model_cfg, num_class: int, point_cloud_range, voxel_size, grid_size,
                 num_point_features: int = 4):
        super().__init__(model_cfg, num_class, point_cloud_range, voxel_size, grid_size,
                         num_point_features)
        rh = self.model_cfg.ROI_HEAD
        self.grid = int(rh.GRID_SIZE)
        self.bev_stride = int(self.model_cfg.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG[0]
                              .feature_map_stride)
        self.iou_mlp = SharedMLP(self.backbone_2d.num_bev_features, rh.SHARED_FC)
        self.iou_head = FCHead(self.iou_mlp.out_channels, rh.IOU_FC, 1)
        self.stages = (*self.STAGE_ONE, "iou_head")

    def forward(self, points, gt_boxes=None, on_stage=None, max_voxels: int = MAX_VOXELS):
        """points (B, N, 3+C) → dict of outputs: in eval mode feed it to
        ``pointrcnn.post_process``, in train mode (``gt_boxes`` (B, M, 8),
        zero-padded) to ``second_iou_loss``. ``on_stage(name)`` is called
        after each of ``self.stages``; ``max_voxels`` as for SECOND."""
        mark = on_stage or (lambda name: None)
        out, _, _, bev2d, proposals = self.stage_one(points, gt_boxes, mark, max_voxels)
        rois, roi_scores, roi_labels, roi_valid = proposals
        if self.training:
            gt_valid = gt_boxes.abs().sum(-1) > 0
            iou = torch.where(gt_valid[:, None, :], boxes_iou3d(rois, gt_boxes[..., :7]), -1.0)
            out["iou_targets"] = iou.amax(dim=-1).clamp(0.0, 1.0)
        b, r, g = rois.shape[0], rois.shape[1], self.grid
        grid_xy = roi_bev_grid(rois, g).reshape(b, r * g * g, 2)
        feats = bilinear_bev(bev2d, grid_xy, self.point_cloud_range, self.voxel_size,
                             self.bev_stride).reshape(b, r, g * g, -1)
        iou_preds = self.iou_head(self.iou_mlp(feats).amax(dim=2))  # (B, R, 1)
        out.update(rcnn_iou=iou_preds, rois=rois, roi_labels=roi_labels, roi_valid=roi_valid,
                   roi_scores=roi_scores)
        if not self.training:
            out["batch_cls_preds"] = iou_preds
            out["batch_box_preds"] = rois
        mark("iou_head")
        return out


def second_iou_loss(out, gt_boxes, cfg, num_class: int = 1):
    """Stage 1's anchor losses + the IoU branch's sigmoid cross-entropy
    against 2·IoU − 0.5 clipped to [0, 1] (reference second_head.get_loss).
    Returns (loss, metrics)."""
    loss1, metrics = grid_detector_loss(out, cfg, num_class)
    target = (2.0 * out["iou_targets"] - 0.5).clamp(0.0, 1.0)
    per = sigmoid_ce_with_logits(out["rcnn_iou"][..., 0], target)
    loss_iou = global_mean(per) * float(cfg.ROI_HEAD.LOSS_CONFIG.LOSS_WEIGHTS.rcnn_iou_weight)
    total = loss1 + loss_iou
    metrics = dict(metrics)
    metrics.update(loss=total, iou_loss=loss_iou)
    return total, metrics
