"""PointRCNN detector, eval forward + post-processing — port of
``modest_tpu/models/pointrcnn.py`` (reference pcdet detectors/point_rcnn.py).

Submodules carry pcdet's names (``backbone_3d``, ``point_head``,
``roi_head``), so ``state_dict()`` keys are pcdet's keys. Training (RoI
sampling, losses) is not ported yet: the forward raises in train mode.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.iou3d import nms_bev
from ..utils.config import Config
from .box_coders import PointResidualCoder, ResidualCoder
from .point_head import PointHeadBox
from .pointnet2_backbone import PointNet2MSG
from .roi_head import PointRCNNHead, generate_refined_boxes, pool_roi_features, proposal_layer

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

    def forward(self, points, on_stage=None):
        """points (B, N, 3+C) → dict of eval outputs; feed to ``post_process``.

        ``on_stage(name)``, when given, is called after each stage named in
        ``STAGES`` (a timer hook; it does not change the computation)."""
        if self.training:
            raise NotImplementedError("PointRCNN port: only the eval forward is ported")
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

        nms_cfg = cfg.ROI_HEAD.NMS_CONFIG.TEST
        rois, roi_scores, roi_labels, roi_valid = proposal_layer(
            decoded, point_cls,
            nms_pre=int(nms_cfg.NMS_PRE_MAXSIZE),
            nms_post=int(nms_cfg.NMS_POST_MAXSIZE),
            nms_thresh=float(nms_cfg.NMS_THRESH))
        mark("proposal_nms")

        pool = cfg.ROI_HEAD.ROI_POINT_POOL
        pooled = pool_roi_features(
            xyz, feats, point_scores, rois, roi_valid,
            num_sampled_points=int(pool.NUM_SAMPLED_POINTS),
            depth_normalizer=float(pool.DEPTH_NORMALIZER),
            pool_extra_width=tuple(pool.POOL_EXTRA_WIDTH))
        mark("roi_pool")
        rcnn_cls, rcnn_reg = self.roi_head(pooled)
        batch_cls, batch_boxes = generate_refined_boxes(rois, rcnn_cls, rcnn_reg, self.roi_coder)
        mark("roi_head")
        return {
            "point_xyz": xyz,
            "point_cls_preds": point_cls,
            "point_box_preds": point_box,
            "point_boxes_decoded": decoded,
            "rcnn_cls": rcnn_cls,
            "rcnn_reg": rcnn_reg,
            "rois": rois,
            "roi_scores": roi_scores,
            "roi_labels": roi_labels,
            "roi_valid": roi_valid,
            "batch_cls_preds": batch_cls,
            "batch_box_preds": batch_boxes,
        }


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
