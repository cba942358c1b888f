"""Detection losses — port of ``modest_tpu/models/losses.py`` (reference
pcdet/utils/loss_utils.py), with the JAX package's arithmetic."""
from __future__ import annotations

import math

import torch

from ..ops.box_torch import boxes_to_corners_3d


def sigmoid_ce_with_logits(logits, targets):
    return logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def sigmoid_focal_loss(logits, targets, weights, gamma=2.0, alpha=0.25):
    """(..., C) logits and one-hot targets, (...,) weights → weighted loss."""
    pred = torch.reciprocal(1 + torch.exp(-logits)).clamp(0.0, 1.0)
    alpha_w = targets * alpha + (1 - targets) * (1 - alpha)
    pt = targets * (1.0 - pred) + (1.0 - targets) * pred
    focal = alpha_w * torch.pow(pt, gamma)
    return focal * sigmoid_ce_with_logits(logits, targets) * weights[..., None]


def smooth_l1(diff, beta=1.0 / 9.0):
    n = diff.abs()
    if beta < 1e-5:
        return n
    return torch.where(n < beta, 0.5 * n * n / beta, n - 0.5 * beta)


def weighted_smooth_l1(preds, targets, weights=None, code_weights=None, beta=1.0 / 9.0):
    """(..., C) → (..., C); nan targets are ignored (reference :122)."""
    targets = torch.where(torch.isnan(targets), preds, targets)
    diff = preds - targets
    if code_weights is not None:
        diff = diff * torch.as_tensor(code_weights, dtype=diff.dtype, device=diff.device)
    loss = smooth_l1(diff, beta)
    if weights is not None:
        loss = loss * weights[..., None]
    return loss


def binary_cross_entropy(probs, targets):
    probs = probs.clamp(1e-7, 1 - 1e-7)
    return -(targets * torch.log(probs) + (1 - targets) * torch.log(1 - probs))


def corner_loss_lidar(pred_boxes, gt_boxes):
    """(N, 7) → (N,) corner loss with the heading-flip minimum (reference
    :209-232)."""
    pred_c = boxes_to_corners_3d(pred_boxes)
    gt_c = boxes_to_corners_3d(gt_boxes)
    gt_flip = torch.cat([gt_boxes[:, :6], gt_boxes[:, 6:7] + math.pi], dim=1)
    gt_c_flip = boxes_to_corners_3d(gt_flip)
    dist = torch.minimum(torch.linalg.norm(pred_c - gt_c, dim=2),
                         torch.linalg.norm(pred_c - gt_c_flip, dim=2))
    return smooth_l1(dist, beta=1.0).mean(dim=1)
