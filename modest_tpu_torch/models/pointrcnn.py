"""PointRCNN detector: forward in train and eval mode, loss and
post-processing — port of ``modest_tpu/models/pointrcnn.py`` (reference pcdet
detectors/point_rcnn.py).

Submodules carry pcdet's names (``backbone_3d``, ``point_head``,
``roi_head``), so ``state_dict()`` keys are pcdet's keys. ``model.train()``
selects the train branch (NMS_CONFIG.TRAIN proposals, RoI sampling against
the gt boxes, batch norm on batch statistics), ``model.eval()`` the eval one.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.iou3d import nms_bev
from ..utils.config import Config
from .box_coders import PointResidualCoder, ResidualCoder
from .point_head import PointHeadBox, assign_point_targets, point_head_loss
from .pointnet2_backbone import PointNet2MSG
from .roi_head import (PointRCNNHead, canonical_transform_gt, generate_refined_boxes,
                       pool_roi_features, proposal_layer, roi_head_loss, sample_rois_for_rcnn,
                       sampler_draws)

STAGES = ("backbone", "point_head", "proposal_nms", "roi_pool", "roi_head")
POINT_FEATURES = 4  # x, y, z, intensity: the Lyft scans' used_feature_list


class PointRCNN(nn.Module):
    def __init__(self, model_cfg, num_class: int):
        super().__init__()
        self.model_cfg = cfg = Config(model_cfg)
        self.num_class = num_class
        self.backbone_3d = PointNet2MSG(cfg.BACKBONE_3D, POINT_FEATURES)
        ph = cfg.POINT_HEAD
        self.point_coder = PointResidualCoder(**ph.TARGET_CONFIG.BOX_CODER_CONFIG.to_dict())
        self.point_head = PointHeadBox(
            self.backbone_3d.num_point_features,
            num_class=1 if ph.CLASS_AGNOSTIC else num_class,
            cls_fc=ph.CLS_FC, reg_fc=ph.REG_FC, code_size=self.point_coder.code_size)
        rh = cfg.ROI_HEAD
        self.roi_coder = ResidualCoder()
        self.roi_head = PointRCNNHead(
            self.backbone_3d.num_point_features, rh,
            num_class=1 if rh.CLASS_AGNOSTIC else num_class,
            code_size=self.roi_coder.code_size)

    def forward(self, points, gt_boxes=None, roi_draws=None, on_stage=None):
        """points (B, N, 3+C) → dict of outputs: in eval mode feed it to
        ``post_process``, in train mode to ``pointrcnn_loss``.

        Train mode needs ``gt_boxes`` (B, M, 8), zero-padded; ``roi_draws``
        are the RoI sampler's draws (``roi_head.sampler_draws``; drawn from
        the global generator when None). ``on_stage(name)``, when given, is
        called after each stage named in ``STAGES`` (a timer hook; it does
        not change the computation)."""
        if self.training and gt_boxes is None:
            raise ValueError("PointRCNN: train mode needs gt_boxes; call .eval() for the "
                             "eval forward")
        mark = on_stage or (lambda name: None)
        cfg = self.model_cfg
        xyz = points[..., :3]
        b, n = points.shape[0], points.shape[1]

        feats = self.backbone_3d(points)  # (B, N, C)
        mark("backbone")
        point_cls, point_box = self.point_head(feats)
        point_scores = torch.sigmoid(point_cls.amax(dim=-1))  # (B, N)
        pred_classes = point_cls.argmax(dim=-1) + 1
        decoded = self.point_coder.decode(
            point_box.reshape(-1, self.point_coder.code_size),
            xyz.reshape(-1, 3), pred_classes.reshape(-1)).reshape(b, n, 7)
        mark("point_head")

        nms_cfg = cfg.ROI_HEAD.NMS_CONFIG["TRAIN" if self.training else "TEST"]
        rois, roi_scores, roi_labels, roi_valid = proposal_layer(
            decoded, point_cls,
            nms_pre=int(nms_cfg.NMS_PRE_MAXSIZE),
            nms_post=int(nms_cfg.NMS_POST_MAXSIZE),
            nms_thresh=float(nms_cfg.NMS_THRESH))
        mark("proposal_nms")
        out = {"point_xyz": xyz, "point_cls_preds": point_cls, "point_box_preds": point_box,
               "point_boxes_decoded": decoded}

        if self.training:
            tcfg = cfg.ROI_HEAD.TARGET_CONFIG
            if roi_draws is None:
                roi_draws = sampler_draws(b, rois.shape[1], int(tcfg.ROI_PER_IMAGE), rois.device)
            targets = sample_rois_for_rcnn(rois, roi_scores, roi_labels, gt_boxes, tcfg,
                                           roi_draws)
            rois = targets["rois"]
            roi_labels = targets["roi_labels"]
            roi_valid = torch.ones(rois.shape[:2], dtype=torch.bool, device=rois.device)
            targets["gt_of_rois_src"] = targets["gt_of_rois"]
            targets["gt_of_rois_ct"] = canonical_transform_gt(rois, targets["gt_of_rois"])
            out["roi_targets"] = targets

        pool = cfg.ROI_HEAD.ROI_POINT_POOL
        pooled = pool_roi_features(
            xyz, feats, point_scores, rois, roi_valid,
            num_sampled_points=int(pool.NUM_SAMPLED_POINTS),
            depth_normalizer=float(pool.DEPTH_NORMALIZER),
            pool_extra_width=tuple(pool.POOL_EXTRA_WIDTH))
        mark("roi_pool")
        # pooled without autograd (pool_roi_features), as the reference pools
        # under no_grad: the RoI head learns from its own losses only
        rcnn_cls, rcnn_reg = self.roi_head(pooled)
        out.update(rcnn_cls=rcnn_cls, rcnn_reg=rcnn_reg, rois=rois, roi_scores=roi_scores,
                   roi_labels=roi_labels, roi_valid=roi_valid)
        if not self.training:
            batch_cls, batch_boxes = generate_refined_boxes(rois, rcnn_cls, rcnn_reg,
                                                            self.roi_coder)
            out.update(batch_cls_preds=batch_cls, batch_box_preds=batch_boxes)
        mark("roi_head")
        return out


def point_losses(out, gt_boxes, cfg, num_class: int = 1):
    """The point head's losses (focal, smooth-L1) and positive count, from
    ``out``'s ``point_xyz``, ``point_cls_preds`` and ``point_box_preds``."""
    ph_cfg = cfg.POINT_HEAD
    num_class = 1 if ph_cfg.CLASS_AGNOSTIC else num_class
    point_coder = PointResidualCoder(**ph_cfg.TARGET_CONFIG.BOX_CODER_CONFIG.to_dict())
    # targets from the raw input points: the backbone keeps the point order
    cls_labels, box_labels = assign_point_targets(
        out["point_xyz"], gt_boxes, point_coder,
        gt_extra_width=tuple(ph_cfg.TARGET_CONFIG.GT_EXTRA_WIDTH), num_class=num_class)
    lw = ph_cfg.LOSS_CONFIG.LOSS_WEIGHTS
    return point_head_loss(
        out["point_cls_preds"], out["point_box_preds"], cls_labels, box_labels,
        num_class=num_class, cls_weight=lw.point_cls_weight, box_weight=lw.point_box_weight,
        code_weights=list(lw.code_weights))


def pointrcnn_loss(out, gt_boxes, cfg, num_class: int = 1):
    """Total loss = point head (focal + smooth-L1) + RCNN (BCE + smooth-L1 +
    corner). Returns (loss, metrics dict of 0-dim tensors)."""
    loss_point_cls, loss_point_box, pos_num = point_losses(out, gt_boxes, cfg, num_class)
    rw = cfg.ROI_HEAD.LOSS_CONFIG.LOSS_WEIGHTS
    loss_rcnn_cls, loss_rcnn_reg, loss_corner = roi_head_loss(
        out["rcnn_cls"], out["rcnn_reg"], out["roi_targets"], ResidualCoder(),
        code_weights=list(rw.code_weights), cls_weight=rw.rcnn_cls_weight,
        reg_weight=rw.rcnn_reg_weight, corner_weight=rw.rcnn_corner_weight)
    total = loss_point_cls + loss_point_box + loss_rcnn_cls + loss_rcnn_reg + loss_corner
    metrics = {
        "loss": total,
        "point_loss_cls": loss_point_cls,
        "point_loss_box": loss_point_box,
        "rcnn_loss_cls": loss_rcnn_cls,
        "rcnn_loss_reg": loss_rcnn_reg + loss_corner,
        "point_pos_num": pos_num,
    }
    return total, metrics


def post_process(out, post_cfg):
    """Score-thresholded NMS over refined boxes (reference
    detector3d_template.post_processing), batched and padded.

    Returns a dict of (B, K) final boxes / scores / labels + validity."""
    batch_cls = out["batch_cls_preds"]  # (B, R, 1)
    batch_boxes = out["batch_box_preds"]  # (B, R, 7)
    nms_cfg = post_cfg.NMS_CONFIG
    scores = torch.sigmoid(batch_cls.amax(dim=-1))  # (B, R)
    ok = out["roi_valid"] & (scores > float(post_cfg.SCORE_THRESH))
    masked = torch.where(ok, scores, float("-inf"))
    k = min(int(nms_cfg.NMS_POST_MAXSIZE), batch_boxes.shape[1])
    keep, keep_mask = nms_bev(batch_boxes, masked, float(nms_cfg.NMS_THRESH), k)
    return {
        "boxes": torch.gather(batch_boxes, 1, keep[..., None].expand(-1, -1, 7)),
        "scores": torch.gather(scores, 1, keep),
        "labels": torch.gather(out["roi_labels"], 1, keep),
        "valid": keep_mask,
    }
