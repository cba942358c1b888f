# Frozen copy of modest_tpu_torch/models/roi_head.py, the benchmark's plain reference: it
# imports nothing of the port and changes only when the benchmark is redefined.
"""Stage-2 RoI head (PointRCNN refinement) — port of
``modest_tpu/models/roi_head.py`` (reference pcdet roi_heads/pointrcnn_head.py,
roi_head_template.py and target_assigner/proposal_target_layer.py).

The train-time RoI sampler has fixed shapes, as in JAX: stable compaction
and indexing by uniform draws take the place of the reference's
nonzero()/cat(). Its randomness is an explicit argument (``draws``), so a
caller can hand it the draws of JAX's "sampler" stream.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from . import pointnet2 as p2
from .box_torch import rotate_points_along_z
from .iou3d import boxes_iou3d, nms_bev
from .mesh import global_sum
from .box_coders import ResidualCoder
from .layers import FCHead, SharedMLP
from .losses import binary_cross_entropy, corner_loss_lidar, weighted_smooth_l1
from .pointnet2_backbone import SAModule

TWO_PI = 2 * math.pi


@torch.no_grad()
def proposal_layer(box_preds, cls_preds, nms_pre: int, nms_post: int, nms_thresh: float):
    """box_preds (B, N, 7), cls_preds (B, N, C) →
    rois (B, nms_post, 7), roi_scores (B, nms_post), roi_labels (B, nms_post),
    roi_valid (B, nms_post). Scores are raw logits (sigmoid is monotonic)."""
    scores, labels = cls_preds.max(dim=-1)
    n = scores.shape[1]
    if nms_pre < n:
        # a stable descending sort puts the lower index first among equal
        # scores, as lax.top_k does; torch.topk promises no tie order
        top_idx = torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :nms_pre]
    else:
        top_idx = torch.arange(n, device=scores.device).expand(scores.shape[0], n)
    top_scores = torch.gather(scores, 1, top_idx)
    top_boxes = torch.gather(box_preds, 1, top_idx[..., None].expand(-1, -1, 7))
    keep, keep_mask = nms_bev(top_boxes, top_scores, nms_thresh, nms_post)
    sel = torch.gather(top_idx, 1, keep)
    rois = torch.where(keep_mask[..., None],
                       torch.gather(box_preds, 1, sel[..., None].expand(-1, -1, 7)), 0.0)
    roi_scores = torch.where(keep_mask, torch.gather(scores, 1, sel), 0.0)
    roi_labels = torch.where(keep_mask, torch.gather(labels, 1, sel) + 1, 0)
    return rois, roi_scores, roi_labels, keep_mask


def sampler_draws(b: int, r: int, s: int, device, generator: torch.Generator | None = None):
    """The RoI sampler's uniform draws for a batch: ``u_fg`` (B, R) ranks
    the foreground pool, ``u_hard`` and ``u_easy`` (B, S) pick from the
    hard and easy background pools. Drawn on the CPU from ``generator`` (the
    global generator when None), so a seed gives the same draws on any
    device."""
    shapes = {"u_fg": (b, r), "u_hard": (b, s), "u_easy": (b, s)}
    return {k: torch.rand(shape, generator=generator).to(device) for k, shape in shapes.items()}


def _randint(u, bound):
    """Ints in [0, bound) from uniform draws u (..., S) and bounds (...,) >= 1:
    min(int(u · bound), bound − 1), the product in float32."""
    bound = bound[..., None]
    return torch.minimum((u * bound.float()).to(torch.int32), bound - 1).long()


def _compact(mask):
    """Indices of the True entries first, in order (a stable sort)."""
    return torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)


@torch.no_grad()
def sample_rois_for_rcnn(rois, roi_scores, roi_labels, gt_boxes, cfg, draws):
    """Subsample ROI_PER_IMAGE RoIs per scene with fg/bg balancing
    (reference proposal_target_layer.py).

    rois (B, R, 7); roi_scores, roi_labels (B, R); gt_boxes (B, M, 8);
    ``draws`` as ``sampler_draws`` gives them. Foreground RoIs are taken
    without replacement in the order of ``u_fg`` (wrapping when the pool is
    short), hard and easy background with replacement, the hard quota
    HARD_BG_RATIO of the background capped by the hard pool, with the
    reference's fallbacks for empty pools. Returns a dict of (B, S, ...)
    tensors, ``roi_idx`` the sampled rows of ``rois``."""
    S = int(cfg.ROI_PER_IMAGE)
    fg_per_image = int(round(cfg.FG_RATIO * S))
    fg_thresh = min(cfg.REG_FG_THRESH, cfg.CLS_FG_THRESH)
    dev = rois.device

    gt_valid = gt_boxes.abs().sum(-1) > 0
    iou = boxes_iou3d(rois, gt_boxes[..., :7])  # (B, R, M)
    pair_ok = gt_valid[:, None, :]
    if bool(cfg.get("SAMPLE_ROI_BY_EACH_CLASS", False)):
        # a RoI only matches gt boxes of its own predicted class
        pair_ok = pair_ok & (roi_labels[:, :, None].to(torch.int32)
                             == gt_boxes[..., -1].to(torch.int32)[:, None, :])
    iou = torch.where(pair_ok, iou, -1.0)
    max_ov = iou.max(dim=-1).values.clamp_min(0.0)
    gt_assign = iou.argmax(dim=-1)  # the first maximum

    fg_mask = max_ov >= fg_thresh
    easy_mask = max_ov < cfg.CLS_BG_THRESH_LO
    hard_mask = (max_ov < cfg.REG_FG_THRESH) & (max_ov >= cfg.CLS_BG_THRESH_LO)
    n_fg_avail = fg_mask.sum(-1)
    n_easy = easy_mask.sum(-1)
    n_hard = hard_mask.sum(-1)
    n_bg_avail = n_easy + n_hard
    n_fg = torch.clamp_max(n_fg_avail, fg_per_image)
    # pool-empty fallbacks (reference subsample_rois:130-159)
    n_fg = torch.where(n_bg_avail == 0, torch.where(n_fg_avail > 0, S, 0), n_fg)
    n_bg = S - n_fg

    prio = draws["u_fg"] + torch.where(fg_mask, 0.0, -10.0)
    fg_order = torch.argsort(-prio, dim=-1, stable=True)
    slot = torch.arange(S, device=dev)
    fg_pick = torch.gather(fg_order, 1, slot[None, :] % n_fg_avail.clamp_min(1)[:, None])

    hard_target = torch.minimum((n_bg.float() * cfg.HARD_BG_RATIO).to(torch.int64), n_hard)
    hard_target = torch.where(n_hard == 0, 0, torch.where(n_easy == 0, n_bg, hard_target))
    hard_pick = torch.gather(_compact(hard_mask), 1, _randint(draws["u_hard"], n_hard.clamp_min(1)))
    easy_pick = torch.gather(_compact(easy_mask), 1, _randint(draws["u_easy"], n_easy.clamp_min(1)))

    is_fg_slot = slot[None, :] < n_fg[:, None]
    is_hard_slot = ~is_fg_slot & ((slot[None, :] - n_fg[:, None]) < hard_target[:, None])
    pick = torch.where(is_fg_slot, fg_pick, torch.where(is_hard_slot, hard_pick, easy_pick))

    def take(x):
        return torch.gather(x, 1, pick.view(*pick.shape, *([1] * (x.ndim - 2))).expand(
            *pick.shape, *x.shape[2:]))

    s_ov = take(max_ov)
    s_gt = torch.gather(gt_boxes, 1, take(gt_assign)[..., None].expand(-1, -1, gt_boxes.shape[-1]))
    reg_valid = (s_ov > cfg.REG_FG_THRESH).to(torch.int32)
    if cfg.get("CLS_SCORE_TYPE", "cls") == "roi_iou":
        # soft labels: the IoU between the bg and fg thresholds
        # (reference proposal_target_layer.py:44-53)
        soft = (s_ov - cfg.CLS_BG_THRESH) / (cfg.CLS_FG_THRESH - cfg.CLS_BG_THRESH)
        cls_labels = soft.clamp(0.0, 1.0)
    else:
        cls_labels = (s_ov > cfg.CLS_FG_THRESH).float()
        interval = (s_ov > cfg.CLS_BG_THRESH) & (s_ov < cfg.CLS_FG_THRESH)
        cls_labels = torch.where(interval, -1.0, cls_labels)
    return dict(rois=take(rois), gt_of_rois=s_gt, gt_iou_of_rois=s_ov,
                roi_scores=take(roi_scores), roi_labels=take(roi_labels),
                reg_valid_mask=reg_valid, rcnn_cls_labels=cls_labels, roi_idx=pick)


@torch.no_grad()
def canonical_transform_gt(rois, gt_of_rois):
    """Gt boxes in each RoI's canonical frame, heading flipped into ±π/2
    (reference roi_head_template.assign_targets:110-130)."""
    roi_ry = rois[..., 6] % TWO_PI
    xyz = gt_of_rois[..., 0:3] - rois[..., 0:3]
    xyz = rotate_points_along_z(xyz[..., None, :], -roi_ry)[..., 0, :]
    heading = (gt_of_rois[..., 6] - roi_ry) % TWO_PI
    opposite = (heading > math.pi * 0.5) & (heading < math.pi * 1.5)
    heading = torch.where(opposite, (heading + math.pi) % TWO_PI, heading)
    heading = torch.where(heading > math.pi, heading - TWO_PI, heading)
    heading = heading.clamp(-math.pi / 2, math.pi / 2)
    return torch.cat([xyz, gt_of_rois[..., 3:6], heading[..., None], gt_of_rois[..., 7:]], -1)


class PointRCNNHead(nn.Module):
    """xyz-up + merge-down + 3-level SA tower + cls/reg heads.

    Only ``xyz_up_layer`` and ``merge_down_layer`` follow ``use_bn``; the SA
    tower and the FC heads always have batch norm, as in the JAX package."""

    def __init__(self, in_channels: int, model_cfg, num_class: int, code_size: int):
        super().__init__()
        use_bn = bool(model_cfg.USE_BN)
        self.num_prefix_channels = 5  # xyz + point score + point depth
        up = list(model_cfg.XYZ_UP_LAYER)
        self.xyz_up_layer = SharedMLP(self.num_prefix_channels, up, use_bn=use_bn)
        self.merge_down_layer = SharedMLP(up[-1] + in_channels, [up[-1]], use_bn=use_bn)
        sa = model_cfg.SA_CONFIG
        self.SA_modules = nn.ModuleList()
        channel_in = up[-1]
        for k in range(len(sa.NPOINTS)):
            npoint = None if sa.NPOINTS[k] == -1 else int(sa.NPOINTS[k])
            mod = SAModule(channel_in, npoint, sa.RADIUS[k], sa.NSAMPLE[k], sa.MLPS[k])
            self.SA_modules.append(mod)
            channel_in = mod.out_channels
        self.cls_layers = FCHead(channel_in, model_cfg.CLS_FC, num_class)
        self.reg_layers = FCHead(channel_in, model_cfg.REG_FC, code_size * num_class)

    def forward(self, pooled_features):
        """pooled_features (BR, ns, 5 + C) → (rcnn_cls (BR, 1), rcnn_reg (BR, code))."""
        pre = self.num_prefix_channels
        xyz_feat = self.xyz_up_layer(pooled_features[..., :pre])
        merged = torch.cat([xyz_feat, pooled_features[..., pre:]], dim=-1)
        l_feat = self.merge_down_layer(merged)
        l_xyz = pooled_features[..., 0:3]
        for sa in self.SA_modules:
            l_xyz, l_feat = sa(l_xyz, l_feat)
        shared = l_feat[:, 0, :]  # (BR, C) after GroupAll
        return self.cls_layers(shared), self.reg_layers(shared)


@torch.no_grad()
def pool_roi_features(point_coords, point_features, point_scores, rois, roi_valid,
                      num_sampled_points: int, depth_normalizer: float,
                      pool_extra_width=(0.0, 0.0, 0.0)):
    """roipool3d + canonical transform (reference pointrcnn_head.py:85-130).

    point_coords (B, N, 3); point_features (B, N, C); point_scores (B, N);
    rois (B, R, 7). Returns (B*R, ns, 5 + C)."""
    depth = torch.linalg.norm(point_coords, dim=-1) / depth_normalizer - 0.5
    feats_all = torch.cat([point_scores[..., None], depth[..., None], point_features], dim=-1)
    pooled, empty = p2.roipoint_pool3d(point_coords, feats_all, rois, num_sampled_points,
                                       pool_extra_width)
    b, r, ns, c = pooled.shape
    xyz = (pooled[..., 0:3] - rois[:, :, None, 0:3]).reshape(b * r, ns, 3)
    xyz = rotate_points_along_z(xyz, -rois[..., 6].reshape(-1))
    pooled = torch.cat([xyz, pooled.reshape(b * r, ns, c)[..., 3:]], dim=-1)
    dead = (empty.reshape(-1) > 0) | ~roi_valid.reshape(-1)
    return torch.where(dead[:, None, None], 0.0, pooled)


def generate_refined_boxes(rois, cls_preds, box_preds, box_coder: ResidualCoder):
    """Decode rcnn_reg in each RoI's frame (reference :230-258).

    rois (B, R, 7); cls_preds (BR, 1); box_preds (BR, code) →
    (batch_cls (B, R, 1), batch_boxes (B, R, 7))."""
    b, r = rois.shape[0], rois.shape[1]
    code_size = box_coder.code_size
    flat_rois = rois.reshape(-1, rois.shape[-1])
    local = torch.cat([torch.zeros_like(flat_rois[:, 0:3]), flat_rois[:, 3:code_size]], -1)
    decoded = box_coder.decode(box_preds.reshape(-1, code_size), local)
    decoded = rotate_points_along_z(decoded[:, None, :], flat_rois[:, 6])[:, 0, :]
    decoded = torch.cat([decoded[:, 0:3] + flat_rois[:, 0:3], decoded[:, 3:]], -1)
    return cls_preds.reshape(b, r, -1), decoded.reshape(b, r, code_size)


def roi_head_loss(rcnn_cls, rcnn_reg, targets, box_coder: ResidualCoder,
                  code_weights, cls_weight=1.0, reg_weight=1.0, corner_weight=1.0):
    """BCE over the sampled RoIs' labels (−1 ignored), smooth-L1 on the
    residuals against RoI anchors at the origin with heading 0, and the
    corner loss of the decoded foreground boxes (reference
    roi_head_template.py:133-228). Returns (cls, reg, corner) losses, each
    normalized by the global batch's counts (``global_sum``)."""
    code_size = box_coder.code_size
    labels = targets["rcnn_cls_labels"].reshape(-1)
    reg_valid = targets["reg_valid_mask"].reshape(-1)
    gt_ct = targets["gt_of_rois_ct"][..., :code_size].reshape(-1, code_size)
    gt_src = targets["gt_of_rois_src"][..., :code_size].reshape(-1, code_size)
    rois = targets["rois"].reshape(-1, targets["rois"].shape[-1])

    probs = torch.sigmoid(rcnn_cls.reshape(-1))
    cls_valid = (labels >= 0).float()
    bce = binary_cross_entropy(probs, labels.clamp_min(0).float())
    loss_cls = (bce * cls_valid).sum() / global_sum(cls_valid.sum()).clamp_min(1.0) * cls_weight

    fg_f = (reg_valid > 0).float()
    fg_sum = global_sum(fg_f.sum()).clamp_min(1.0)
    zeros3 = torch.zeros_like(rois[:, 0:3])
    rois_anchor = torch.cat([zeros3, rois[:, 3:6], torch.zeros_like(rois[:, 6:7])], -1)
    reg_targets = box_coder.encode(gt_ct, rois_anchor)
    reg_l = weighted_smooth_l1(rcnn_reg.reshape(1, -1, code_size), reg_targets[None],
                               code_weights=code_weights)[0]
    loss_reg = (reg_l.sum(-1) * fg_f).sum() / fg_sum * reg_weight

    # the decode anchors keep the RoI heading (only xyz zeroed), unlike the
    # heading-0 anchors of the reg targets (reference :170-181)
    anchors_c = torch.cat([zeros3, rois[:, 3:code_size]], -1)
    decoded = box_coder.decode(rcnn_reg.reshape(-1, code_size), anchors_c)
    decoded = rotate_points_along_z(decoded[:, None, :], rois[:, 6])[:, 0, :]
    decoded = torch.cat([decoded[:, 0:3] + rois[:, 0:3], decoded[:, 3:]], -1)
    corner = corner_loss_lidar(decoded[:, :7], gt_src[:, :7])
    loss_corner = (corner * fg_f).sum() / fg_sum * corner_weight
    return loss_cls, loss_reg, loss_corner
