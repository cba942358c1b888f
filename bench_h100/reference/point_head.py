# Frozen copy of modest_tpu_torch/models/point_head.py, the benchmark's plain reference: it
# imports nothing of the port and changes only when the benchmark is redefined.
"""Stage-1 point head: per-point foreground classification and box
regression, with its targets and loss — port of
``modest_tpu/models/point_head.py`` (reference pcdet
dense_heads/point_head_box.py + point_head_template.py)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .box_torch import enlarge_box3d, points_in_boxes_index
from .mesh import global_sum
from .box_coders import PointResidualCoder
from .layers import FCHead
from .losses import sigmoid_focal_loss, weighted_smooth_l1


class PointHeadBox(nn.Module):
    def __init__(self, in_channels: int, num_class: int, cls_fc, reg_fc, code_size: int):
        super().__init__()
        self.cls_layers = FCHead(in_channels, cls_fc, num_class)
        self.box_layers = FCHead(in_channels, reg_fc, code_size)

    def forward(self, point_features):
        """(B, N, C) → (cls_preds (B, N, num_class), box_preds (B, N, code))."""
        return self.cls_layers(point_features), self.box_layers(point_features)


@torch.no_grad()
def assign_point_targets(points_xyz, gt_boxes, box_coder: PointResidualCoder,
                         gt_extra_width=(0.2, 0.2, 0.2), num_class: int = 1):
    """Per-point cls/box targets (reference assign_stack_targets:49-129).

    points_xyz (B, N, 3); gt_boxes (B, M, 8) zero-padded, last column the
    class. Returns cls_labels (B, N) int32 (0 background, -1 ignored, 1..C
    foreground) and box_labels (B, N, 8) (zeros off the foreground)."""
    extend = enlarge_box3d(gt_boxes[..., :7], gt_extra_width)
    valid = gt_boxes.abs().sum(-1) > 0
    idx = points_in_boxes_index(points_xyz, gt_boxes[..., :7], valid)  # (B, N)
    ext_idx = points_in_boxes_index(points_xyz, extend, valid)
    fg = idx >= 0
    ignore = fg ^ (ext_idx >= 0)
    b, n = idx.shape
    gt_of_pts = torch.gather(gt_boxes, 1, idx.clamp_min(0)[..., None].expand(-1, -1, 8))
    cls_of_pts = gt_of_pts[..., -1].to(torch.int32)
    one = torch.ones_like(cls_of_pts)
    labels = torch.where(fg, cls_of_pts if num_class > 1 else one, 0)
    labels = torch.where(ignore, -1, labels).to(torch.int32)
    box_labels = box_coder.encode(gt_of_pts[..., :7].reshape(-1, 7), points_xyz.reshape(-1, 3),
                                  cls_of_pts.reshape(-1)).reshape(b, n, -1)
    return labels, torch.where(fg[..., None], box_labels, 0.0)


def point_head_loss(cls_preds, box_preds, cls_labels, box_labels, num_class: int,
                    cls_weight=1.0, box_weight=1.0, code_weights=None):
    """Focal cls + smooth-L1 reg (reference point_head_template.py:131-191).
    Returns (loss_cls, loss_box, the clipped positive count). The counts are
    the global batch's (``global_sum``): in a process group each loss is this
    process's share."""
    cls_preds = cls_preds.reshape(-1, num_class)
    cls_labels = cls_labels.reshape(-1)
    positives = cls_labels > 0
    negatives = cls_labels == 0
    cls_w = (negatives.float() + 1.0 * positives.float())
    pos_norm = global_sum(positives.sum().float()).clamp_min(1.0)
    cls_w = cls_w / pos_norm
    one_hot = F.one_hot(cls_labels.long().clamp_min(0), num_class + 1)[:, 1:].to(cls_preds.dtype)
    loss_cls = sigmoid_focal_loss(cls_preds, one_hot, cls_w).sum() * cls_weight

    box_preds = box_preds.reshape(-1, box_preds.shape[-1])
    box_labels = box_labels.reshape(-1, box_labels.shape[-1])
    reg_w = positives.float()
    reg_w = reg_w / global_sum(reg_w.sum()).clamp_min(1.0)
    loss_box = weighted_smooth_l1(box_preds[None], box_labels[None], reg_w[None],
                                  code_weights).sum() * box_weight
    return loss_cls, loss_box, pos_norm
