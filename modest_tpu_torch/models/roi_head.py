"""Stage-2 RoI head (PointRCNN refinement), eval pieces — port of
``modest_tpu/models/roi_head.py`` (reference pcdet roi_heads/pointrcnn_head.py
and roi_head_template.py)."""
from __future__ import annotations

import torch
from torch import nn

from ..ops import pointnet2 as p2
from ..ops.box_torch import rotate_points_along_z
from ..ops.iou3d import nms_bev
from .box_coders import ResidualCoder
from .layers import FCHead, SharedMLP
from .pointnet2_backbone import SAModule


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
