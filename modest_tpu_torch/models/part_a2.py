"""Part-A² — port of ``modest_tpu/models/part_a2.py`` (reference pcdet
detectors/PartA2_net.py, dense_heads/point_intra_part_head.py,
roi_heads/partA2_head.py).

Stage 1 is SECOND's BEV path on the sparse UNet's encoder
(``models/sparse_conv.py::SparseUNet``); the UNet's decoder gives each
input voxel 16 features, from which a point-wise head predicts the voxel's
foreground score and its intra-object part location (its position inside
its gt box, each coordinate in [0, 1]). Stage 2 pools the part locations
and scores (mean) and the UNet features (max) RoI-aware onto a G³ grid per
proposal (``ops/roiaware_pool3d.py``) and refines the proposal with a dense
3-D conv tower.

As in the JAX package: the tower's convs pad as flax's ``padding="SAME"``
does (at stride 2, (0, 1) on each axis, not torch's (1, 1)), and its output
is flattened channel-last before ``roi_shared_fc``; padded voxels' centres
sit at 1e6, so no box holds them; the head has no dropout (``DP_RATIO`` is
not read); the RoI sampler takes its draws as an argument. The
anchor-free ``PartA2Free`` (a ``PointRCNN`` with the ``UNetV2`` backbone)
has a point head on the UNet's voxels in place of the BEV RPN and the same
RoI tower. Module names follow the JAX package's (``seg_head``,
``part_head``, ``pool_proj``, ``conv_tower``, ``roi_shared_fc``,
``rcnn_cls``, ``rcnn_reg``); stage 1 keeps pcdet's, the anchor-free
point head PointRCNN's (``point_head.{cls,box}_layers``).
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.roiaware_pool3d import roiaware_cells, roiaware_pool3d
from ..parallel.mesh import global_sum
from ..utils.config import Config
from .box_coders import PointResidualCoder, ResidualCoder
from .grid_detectors import MAX_VOXELS, TwoStageGridDetector, grid_detector_loss
from .layers import BatchNorm3d, FCHead, SharedMLP
from .losses import binary_cross_entropy, sigmoid_focal_loss
from .point_head import PointHeadBox, assign_point_targets, point_head_loss
from .pv_rcnn import voxel_centers
from .roi_head import (canonical_transform_gt, generate_refined_boxes, proposal_layer,
                       roi_head_loss, sample_rois_for_rcnn, sampler_draws)
from .sparse_conv import SparseUNet
from .voxel_rcnn import rcnn_refinement_loss
from .voxelize import point_voxel_coords, voxelize_sparse


@torch.no_grad()
def intra_part_targets(centers, valid, gt_boxes):
    """Per voxel the segmentation label and the canonical intra-part
    location in [0, 1] in the first gt box that holds it (reference
    point_intra_part_head.assign_targets). centers (B, V, 3), valid (B, V),
    gt_boxes (B, M, 8) zero-padded → (seg (B, V) float, part (B, V, 3))."""
    gt_valid = gt_boxes.abs().sum(-1) > 0  # (B, M)
    shift = centers[:, None, :, :] - gt_boxes[:, :, None, :3]  # (B, M, V, 3)
    c, s = torch.cos(-gt_boxes[..., 6])[..., None], torch.sin(-gt_boxes[..., 6])[..., None]
    lx = shift[..., 0] * c - shift[..., 1] * s
    ly = shift[..., 0] * s + shift[..., 1] * c
    lz = shift[..., 2]
    half = gt_boxes[:, :, None, 3:6] / 2
    inb = ((lx.abs() < half[..., 0]) & (ly.abs() < half[..., 1]) & (lz.abs() < half[..., 2])
           & gt_valid[..., None])
    any_hit = inb.any(dim=1) & valid
    first = inb.to(torch.uint8).argmax(dim=1)  # the first box holding the voxel (B, V)
    local = torch.stack([lx, ly, lz], dim=-1)  # (B, M, V, 3)
    sel = local.gather(1, first[:, None, :, None].expand(-1, 1, -1, 3))[:, 0]
    dims = gt_boxes[..., 3:6].gather(1, first[..., None].expand(-1, -1, 3))
    part = (sel / dims.clamp_min(1e-3) + 0.5).clamp(0.0, 1.0)
    return any_hit.float(), torch.where(any_hit[..., None], part, 0.0)


def same_padding(size: int, stride: int, kernel: int = 3):
    """flax's ``padding="SAME"`` for one axis: (low, high)."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class ConvBlock3d(nn.Module):
    """Conv3d (with bias) at flax's SAME padding → ``BatchNorm3d`` → ReLU."""

    def __init__(self, in_channels: int, out_channels: int, stride: int):
        super().__init__()
        self.stride = int(stride)
        self.conv = nn.Conv3d(in_channels, out_channels, 3, stride=self.stride)
        self.bn = BatchNorm3d(out_channels)

    def forward(self, x):  # (N, C, D, H, W)
        pads = []
        for size in reversed(x.shape[2:]):
            pads.extend(same_padding(size, self.stride))
        return torch.relu(self.bn(self.conv(nn.functional.pad(x, pads))))


class PartRoITower:
    """Part-A²'s RoI head, shared by ``PartA2`` and ``PartA2Free``: RoI-aware
    pooling of a 4-channel part stream (mean) and the UNet's 16 features
    (max) onto a G³ grid, ``pool_proj``, the 3-D ``conv_tower``,
    ``roi_shared_fc`` and the ``rcnn_cls`` / ``rcnn_reg`` heads."""

    UNET_CHANNELS = 16

    def build_roi_tower(self, rh):
        self.grid = int(rh.ROI_AWARE_POOL.POOL_SIZE)
        self.pool_proj = SharedMLP(4 + self.UNET_CHANNELS, [int(rh.ROI_AWARE_POOL.NUM_FEATURES)])
        blocks, c_in, size = [], self.pool_proj.out_channels, self.grid
        for c, stride in zip(rh.CONV_TOWER.NUM_FILTERS, rh.CONV_TOWER.STRIDES):
            blocks.append(ConvBlock3d(c_in, int(c), int(stride)))
            c_in, size = int(c), -(-size // int(stride))
        self.conv_tower = nn.ModuleList(blocks)
        self.roi_coder = ResidualCoder()
        self.roi_shared_fc = SharedMLP(size ** 3 * c_in, rh.SHARED_FC)
        shared = self.roi_shared_fc.out_channels
        self.rcnn_cls = FCHead(shared, rh.CLS_FC, 1)
        self.rcnn_reg = FCHead(shared, rh.REG_FC, self.roi_coder.code_size)

    def refine(self, out, proposals, centers, valid, part_stream, u1, mark):
        """Pool, the tower and the heads on ``proposals`` (rois, roi_scores,
        roi_labels, roi_valid); fills ``out`` (with the refined boxes in
        eval mode). Padded voxels' centres go to 1e6, so no box holds them."""
        rois, roi_scores, roi_labels, roi_valid = proposals
        g = self.grid
        centers_m = torch.where(valid[..., None], centers, 1e6)
        cells = roiaware_cells(rois, centers_m, (g, g, g))
        part_pool = roiaware_pool3d(rois, centers_m, part_stream, g, "avg", cells)
        feat_pool = roiaware_pool3d(rois, centers_m, u1, g, "max", cells)
        b, r = rois.shape[:2]
        x = self.pool_proj(torch.cat([part_pool, feat_pool], dim=-1))  # (B, R, g, g, g, C)
        mark("roi_pool")
        x = x.reshape(b * r, g, g, g, -1).permute(0, 4, 1, 2, 3)
        for block in self.conv_tower:
            x = block(x)
        shared = self.roi_shared_fc(x.permute(0, 2, 3, 4, 1).reshape(b, r, -1))
        rcnn_cls = self.rcnn_cls(shared)
        rcnn_reg = self.rcnn_reg(shared)
        out.update(rcnn_cls=rcnn_cls, rcnn_reg=rcnn_reg, rois=rois, roi_scores=roi_scores,
                   roi_labels=roi_labels, roi_valid=roi_valid)
        if not self.training:
            out["batch_cls_preds"], out["batch_box_preds"] = generate_refined_boxes(
                rois, rcnn_cls, rcnn_reg, self.roi_coder)
        mark("roi_head")
        return out


class PartA2(PartRoITower, TwoStageGridDetector):
    """Part-A² with one anchor head: ``model.train()`` adds the anchor, part
    and RoI targets, ``model.eval()`` gives refined boxes to
    ``pointrcnn.post_process``."""

    def __init__(self, model_cfg, num_class: int, point_cloud_range, voxel_size, grid_size,
                 num_point_features: int = 4):
        super().__init__(model_cfg, num_class, point_cloud_range, voxel_size, grid_size,
                         num_point_features)
        cfg = self.model_cfg
        self.seg_head = FCHead(self.UNET_CHANNELS, cfg.POINT_HEAD.CLS_FC, 1)
        self.part_head = FCHead(self.UNET_CHANNELS, cfg.POINT_HEAD.PART_FC, 3)
        self.build_roi_tower(cfg.ROI_HEAD)
        self.stages = (*self.STAGE_ONE, "part_head", "roi_pool", "roi_head")

    def forward(self, points, gt_boxes=None, roi_draws=None, on_stage=None,
                max_voxels: int = MAX_VOXELS):
        """points (B, N, 3+C) → dict of outputs: in eval mode feed it to
        ``pointrcnn.post_process``, in train mode (``gt_boxes`` (B, M, 8),
        zero-padded) to ``parta2_loss``. ``roi_draws`` as for Voxel R-CNN;
        ``on_stage(name)`` is called after each of ``self.stages``;
        ``max_voxels`` as for SECOND."""
        mark = on_stage or (lambda name: None)
        out, (vc, _, vv, _), u1, _, proposals = self.stage_one(points, gt_boxes, mark,
                                                               max_voxels)
        centers = voxel_centers(vc, 1, self.point_cloud_range, self.voxel_size)
        seg_logits = self.seg_head(u1)[..., 0]  # (B, V)
        part_reg = torch.sigmoid(self.part_head(u1))  # (B, V, 3)
        out.update(seg_logits=seg_logits, part_reg=part_reg, voxel_valid=vv)
        if self.training:
            out["seg_targets"], out["part_targets"] = intra_part_targets(centers, vv, gt_boxes)
            proposals = self.sample_rois(out, proposals, gt_boxes, roi_draws)
        mark("part_head")
        part_stream = torch.cat([part_reg, torch.sigmoid(seg_logits)[..., None]], dim=-1)
        return self.refine(out, proposals, centers, vv, part_stream, u1, mark)


class PartA2Free(PartRoITower, nn.Module):
    """The anchor-free Part-A² (reference kitti_models/PartA2_free.yaml:
    NAME PointRCNN with the UNetV2 backbone; JAX ``PartA2Free``): no BEV
    RPN. The UNet's voxel features feed a point head (class logits and
    ``PointResidualCoder`` box residuals against the mean sizes, per voxel
    centre) and the part head; the decoded voxel boxes are the proposals,
    refined by Part-A²'s RoI tower. With ``DISABLE_PART`` the voxel centres
    take the part locations' place in the pooled stream (reference
    partA2_head.py:122). Its eval outputs go to ``pointrcnn.post_process``,
    its train outputs to ``parta2_free_loss``."""

    def __init__(self, model_cfg, num_class: int, point_cloud_range, voxel_size, grid_size,
                 num_point_features: int = 4):
        super().__init__()
        self.model_cfg = cfg = Config(model_cfg)
        self.num_class = num_class
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.grid_size = tuple(int(v) for v in grid_size)
        self.backbone_3d = SparseUNet(num_point_features)
        ph = cfg.POINT_HEAD
        self.point_coder = PointResidualCoder(**ph.TARGET_CONFIG.BOX_CODER_CONFIG.to_dict())
        self.point_head = PointHeadBox(
            self.UNET_CHANNELS, num_class=1 if ph.get("CLASS_AGNOSTIC", False) else num_class,
            cls_fc=ph.CLS_FC, reg_fc=ph.REG_FC, code_size=self.point_coder.code_size)
        self.part_head = FCHead(self.UNET_CHANNELS, ph.PART_FC, 3)
        self.build_roi_tower(cfg.ROI_HEAD)
        self.stages = ("voxelize", "backbone_3d", "point_head", "proposal", "roi_pool",
                       "roi_head")

    def forward(self, points, gt_boxes=None, roi_draws=None, on_stage=None,
                max_voxels: int = MAX_VOXELS):
        """points (B, N, 3+C) → dict of outputs; ``gt_boxes`` (B, M, 8)
        zero-padded in train mode, ``roi_draws`` the RoI sampler's draws
        (from the global generator when None), ``on_stage`` and
        ``max_voxels`` as for Part-A²."""
        if self.training and gt_boxes is None:
            raise ValueError("PartA2Free: train mode needs gt_boxes; call .eval() for the eval "
                             "forward")
        mark = on_stage or (lambda name: None)
        cfg = self.model_cfg
        gs = self.grid_size
        coords, valid = point_voxel_coords(points, self.point_cloud_range, self.voxel_size, gs)
        vc, vf, vv, vk = voxelize_sparse(points, valid, coords, max_voxels, *gs)
        mark("voxelize")
        _, u1 = self.backbone_3d(vf, vc, vk, vv, (gs[2] + 1, gs[1], gs[0]))
        mark("backbone_3d")
        centers = voxel_centers(vc, 1, self.point_cloud_range, self.voxel_size)
        b, v = u1.shape[:2]
        point_cls, point_box = self.point_head(u1)
        point_cls = torch.where(vv[..., None], point_cls, -1e9)  # padded voxels out
        part_reg = torch.sigmoid(self.part_head(u1))
        point_scores = torch.sigmoid(point_cls.amax(dim=-1))
        decoded = self.point_coder.decode(
            point_box.reshape(-1, self.point_coder.code_size), centers.reshape(-1, 3),
            (point_cls.argmax(dim=-1) + 1).reshape(-1)).reshape(b, v, 7)
        out = {"point_cls_preds": point_cls, "point_box_preds": point_box, "part_reg": part_reg,
               "voxel_valid": vv, "point_boxes_decoded": decoded}
        mark("point_head")
        nms_cfg = cfg.ROI_HEAD.NMS_CONFIG["TRAIN" if self.training else "TEST"]
        proposals = proposal_layer(decoded, point_cls, nms_pre=int(nms_cfg.NMS_PRE_MAXSIZE),
                                   nms_post=int(nms_cfg.NMS_POST_MAXSIZE),
                                   nms_thresh=float(nms_cfg.NMS_THRESH))
        if self.training:
            ph = cfg.POINT_HEAD
            cls_labels, out["point_box_labels"] = assign_point_targets(
                centers, gt_boxes, self.point_coder,
                gt_extra_width=tuple(ph.TARGET_CONFIG.GT_EXTRA_WIDTH), num_class=self.num_class)
            out["point_cls_labels"] = torch.where(vv, cls_labels, -1)
            out["seg_targets"], out["part_targets"] = intra_part_targets(centers, vv, gt_boxes)
            rois, roi_scores, roi_labels, _ = proposals
            tcfg = cfg.ROI_HEAD.TARGET_CONFIG
            if roi_draws is None:
                roi_draws = sampler_draws(b, rois.shape[1], int(tcfg.ROI_PER_IMAGE), rois.device)
            targets = sample_rois_for_rcnn(rois, roi_scores, roi_labels, gt_boxes, tcfg,
                                           roi_draws)
            targets["gt_of_rois_src"] = targets["gt_of_rois"]
            targets["gt_of_rois_ct"] = canonical_transform_gt(targets["rois"],
                                                              targets["gt_of_rois"])
            out["roi_targets"] = targets
            proposals = (targets["rois"], targets["roi_scores"], targets["roi_labels"],
                         torch.ones(targets["rois"].shape[:2], dtype=torch.bool,
                                    device=points.device))
        mark("proposal")
        score = point_scores.detach()[..., None]
        first = centers if bool(cfg.ROI_HEAD.get("DISABLE_PART", False)) else part_reg
        return self.refine(out, proposals, centers, vv, torch.cat([first, score], dim=-1), u1,
                           mark)


def parta2_loss(out, gt_boxes, cfg, num_class: int = 1):
    """Stage 1's anchor losses + the voxels' segmentation focal loss + the
    foreground voxels' part-location BCE + the RCNN refinement losses
    (reference PartA2_net.get_training_loss). Returns (loss, metrics)."""
    loss1, metrics = grid_detector_loss(out, cfg, num_class)
    lw = cfg.POINT_HEAD.LOSS_CONFIG.LOSS_WEIGHTS
    valid = out["voxel_valid"]
    seg_t = out["seg_targets"]
    w = valid.float()
    seg_per = sigmoid_focal_loss(out["seg_logits"][..., None], seg_t[..., None], w)[..., 0]
    loss_seg = seg_per.sum() / global_sum(w.sum()).clamp_min(1.0) * float(lw.point_cls_weight)
    fw = ((seg_t > 0.5) & valid).float()
    part_per = binary_cross_entropy(out["part_reg"], out["part_targets"]).sum(-1)
    loss_part = ((part_per * fw).sum() / global_sum(fw.sum()).clamp_min(1.0)
                 * float(lw.point_part_weight))
    loss_cls, loss_reg, loss_corner = rcnn_refinement_loss(out, cfg)
    total = loss1 + loss_seg + loss_part + loss_cls + loss_reg + loss_corner
    metrics = dict(metrics)
    metrics.update(loss=total, seg_loss=loss_seg, part_loss=loss_part, rcnn_loss_cls=loss_cls,
                   rcnn_loss_reg=loss_reg + loss_corner)
    return total, metrics


def parta2_free_loss(out, gt_boxes, cfg, num_class: int = 1):
    """The point head's focal and smooth-L1 losses + the foreground voxels'
    part-location BCE + the RCNN refinement losses (reference PointRCNN's
    get_training_loss with the part head; no RPN). Returns (loss, metrics)."""
    lw = cfg.POINT_HEAD.LOSS_CONFIG.LOSS_WEIGHTS
    loss_cls, loss_box, _ = point_head_loss(
        out["point_cls_preds"], out["point_box_preds"], out["point_cls_labels"],
        out["point_box_labels"], num_class, cls_weight=float(lw.point_cls_weight),
        box_weight=float(lw.point_box_weight), code_weights=list(lw.code_weights))
    fw = ((out["seg_targets"] > 0.5) & out["voxel_valid"]).float()
    part_per = binary_cross_entropy(out["part_reg"], out["part_targets"]).sum(-1)
    loss_part = ((part_per * fw).sum() / global_sum(fw.sum()).clamp_min(1.0)
                 * float(lw.get("point_part_weight", 1.0)))
    rw = cfg.ROI_HEAD.LOSS_CONFIG.LOSS_WEIGHTS
    loss_rcnn_cls, loss_rcnn_reg, loss_corner = roi_head_loss(
        out["rcnn_cls"], out["rcnn_reg"], out["roi_targets"], ResidualCoder(),
        code_weights=list(rw.get("code_weights", [1.0] * 7)), cls_weight=rw.rcnn_cls_weight,
        reg_weight=rw.rcnn_reg_weight, corner_weight=rw.rcnn_corner_weight)
    total = loss_cls + loss_box + loss_part + loss_rcnn_cls + loss_rcnn_reg + loss_corner
    metrics = {"loss": total, "point_loss_cls": loss_cls, "point_loss_box": loss_box,
               "part_loss": loss_part, "rcnn_loss_cls": loss_rcnn_cls,
               "rcnn_loss_reg": loss_rcnn_reg + loss_corner}
    return total, metrics
