"""PV-RCNN: SECOND's voxel stage, keypoint set abstraction and the RoI-grid
head — port of ``modest_tpu/models/pv_rcnn.py`` (reference pcdet
detectors/pv_rcnn.py, backbones_3d/pfe/voxel_set_abstraction.py,
roi_heads/pvrcnn_head.py, dense_heads/point_head_simple.py).

Stage 1 is the grid detector's SECOND path (voxelization, VoxelBackBone8x,
height compression, BaseBEVBackbone, AnchorHeadSingle), so ``PVRCNN``
extends ``GridDetector``. Beside it, FPS picks ``NUM_KEYPOINTS`` keypoints
of the raw points (the hand kernel of ``csrc/fps.cu`` on the card) and the
voxel set abstraction (VSA) gathers each keypoint's neighbours from the
raw points and from the backbone's four sparse scales by masked ball
queries (``ops/pointnet2_stack.py``), plus the BEV map by bilinear
interpolation. The predicted keypoint weight (PKW) head scales the fused
keypoint features; the RoI-grid head pools them onto a G³ grid of points in
each proposal and refines it.

As in the JAX package, the RoI head has no dropout (``DP_RATIO`` is not
read), and the train forward's RoI sampler takes its draws as an argument.
Module names follow the JAX package's (``vsa.<source>``, ``vsa_fusion``,
``pkw_head``, ``roi_grid_pool``, ``roi_shared_fc``, ``rcnn_cls``,
``rcnn_reg``); stage 1 keeps pcdet's (``backbone_3d``, ``backbone_2d``,
``dense_head``).
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops import pointnet2 as p2
from ..ops.box_torch import points_in_boxes_index
from ..ops.pointnet2_stack import query_and_group_masked
from ..parallel.mesh import global_mean
from .box_coders import ResidualCoder
from .grid_detectors import MAX_VOXELS, GridDetector, grid_detector_loss
from .layers import FCHead, SharedMLP
from .losses import binary_cross_entropy
from .roi_head import (canonical_transform_gt, generate_refined_boxes, proposal_layer,
                       roi_head_loss, sample_rois_for_rcnn, sampler_draws)
from .sparse_conv import BACKBONE_STRIDES
from .voxelize import point_voxel_coords, voxelize_sparse

BEV_STRIDE = 8  # the height-compressed map's cell, in voxels


def bilinear_bev(bev, xy, pcr, vs, stride: int):
    """Bilinear interpolation of the BEV map (B, C, H, W) at lidar (x, y)
    points (B, K, 2) → (B, K, C). Rows are y and columns x, cells of
    vs·stride; grid index i is the sample coordinate (no half-cell shift),
    as in the reference's ``bilinear_interpolate_torch``."""
    b, c, h, w = bev.shape
    fx = (xy[..., 0] - pcr[0]) / (vs[0] * stride)
    fy = (xy[..., 1] - pcr[1]) / (vs[1] * stride)
    x0 = torch.floor(fx).to(torch.int64).clamp(0, w - 2)
    y0 = torch.floor(fy).to(torch.int64).clamp(0, h - 2)
    tx = (fx - x0).clamp(0.0, 1.0)[..., None]
    ty = (fy - y0).clamp(0.0, 1.0)[..., None]
    flat = bev.reshape(b, c, h * w)

    def gather(yy, xx):
        return torch.gather(flat, 2, (yy * w + xx)[:, None, :].expand(-1, c, -1)).transpose(1, 2)

    f00 = gather(y0, x0)
    f01 = gather(y0, x0 + 1)
    f10 = gather(y0 + 1, x0)
    f11 = gather(y0 + 1, x0 + 1)
    return (f00 * (1 - tx) + f01 * tx) * (1 - ty) + (f10 * (1 - tx) + f11 * tx) * ty


def voxel_centers(coords_zyx, stride: int, pcr, vs):
    """(B, V, 3) zyx voxel coords at ``stride`` → lidar-frame xyz centres."""
    xyz_idx = coords_zyx.flip(-1).to(torch.float32)
    dev = coords_zyx.device
    size = torch.tensor(vs, dtype=torch.float32, device=dev) * stride
    return (xyz_idx + 0.5) * size + torch.tensor(pcr[:3], dtype=torch.float32, device=dev)


def roi_grid_points(rois, g: int):
    """(B, R, 7) RoIs → (B, R, g³, 3): the centres of a g × g × g grid in
    each RoI (reference pvrcnn_head.get_global_grid_points_of_roi), cell
    (i, j, k) at row i·g² + j·g + k."""
    ar = torch.arange(g, device=rois.device)
    idx = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"), dim=-1).reshape(-1, 3)
    frac = (idx.to(torch.float32) + 0.5) / g - 0.5  # (-0.5, 0.5)
    local = frac[None, None] * rois[:, :, None, 3:6]  # (B, R, g³, 3)
    c, s = torch.cos(rois[..., 6])[..., None], torch.sin(rois[..., 6])[..., None]
    lx, ly, lz = local[..., 0], local[..., 1], local[..., 2]
    gx = lx * c - ly * s
    gy = lx * s + ly * c
    return torch.stack([gx, gy, lz], dim=-1) + rois[:, :, None, :3]


class VSASource(nn.ModuleList):
    """One set-abstraction source: per radius a masked ball query around
    the centres, a shared MLP over the grouped (offset, feature) rows and a
    max over the samples; the radii's outputs concatenated."""

    def __init__(self, in_channels: int, radii, nsamples, mlps):
        super().__init__([SharedMLP(3 + in_channels, [int(c) for c in mlp]) for mlp in mlps])
        self.radii = tuple(float(r) for r in radii)
        self.nsamples = tuple(int(n) for n in nsamples)
        self.out_channels = sum(int(mlp[-1]) for mlp in mlps)

    def forward(self, xyz, xyz_mask, feats, centres):
        """xyz (B, N, 3), xyz_mask (B, N), feats (B, N, C), centres (B, M, 3)
        → (B, M, out_channels)."""
        outs = []
        for radius, nsample, mlp in zip(self.radii, self.nsamples, self):
            grouped, _ = query_and_group_masked(xyz, xyz_mask, feats, centres, radius, nsample)
            outs.append(mlp(grouped).amax(dim=2))
        return torch.cat(outs, dim=-1)


class PVRCNN(GridDetector):
    """PV-RCNN with one anchor head. ``model.train()`` selects the train
    branch (anchor targets, RoI sampling against the gt boxes, batch norms
    on batch statistics), ``model.eval()`` the eval one (refined boxes for
    ``pointrcnn.post_process``). Its stage 1 is one head whatever the
    config's head and backbone names (``GROUPED_ROUTE`` off, VoxelBackBone8x),
    as in the JAX package."""

    GROUPED_ROUTE = False

    def __init__(self, model_cfg, num_class: int, point_cloud_range, voxel_size, grid_size,
                 num_point_features: int = 4):
        super().__init__(model_cfg, num_class, point_cloud_range, voxel_size, grid_size,
                         num_point_features)
        cfg = self.model_cfg
        self.backbone_3d.return_multiscale = True
        pfe = cfg.PFE
        channels = {"raw_points": num_point_features - 3, "x_conv1": 16, "x_conv2": 32,
                    "x_conv3": 64, "x_conv4": 64}
        self.vsa = nn.ModuleDict()
        fused = 0
        for name in pfe.FEATURES_SOURCE:
            if name == "bev":
                fused += self.num_bev_features
                continue
            sa = pfe.SA_LAYER[name]
            self.vsa[name] = VSASource(channels[name], sa.POOL_RADIUS, sa.NSAMPLE, sa.MLPS)
            fused += self.vsa[name].out_channels
        self.vsa_fusion = SharedMLP(fused, [int(pfe.NUM_OUTPUT_FEATURES)])
        self.pkw_head = FCHead(fused, cfg.POINT_HEAD.CLS_FC, 1)
        rh = cfg.ROI_HEAD
        gp = rh.ROI_GRID_POOL
        self.grid = int(gp.GRID_SIZE)
        self.roi_grid_pool = VSASource(int(pfe.NUM_OUTPUT_FEATURES), gp.POOL_RADIUS, gp.NSAMPLE,
                                       gp.MLPS)
        self.roi_coder = ResidualCoder()
        self.roi_shared_fc = SharedMLP(self.grid ** 3 * self.roi_grid_pool.out_channels,
                                       rh.SHARED_FC)
        shared = self.roi_shared_fc.out_channels
        self.rcnn_cls = FCHead(shared, rh.CLS_FC, 1)
        self.rcnn_reg = FCHead(shared, rh.REG_FC, self.roi_coder.code_size)
        self.stages = ("voxelize", "backbone_3d", "backbone_2d", "dense_head", "keypoint_fps",
                       *(f"vsa_{name}" for name in pfe.FEATURES_SOURCE), "vsa_fusion",
                       "proposal", "grid_pool", "roi_head")

    def forward(self, points, gt_boxes=None, roi_draws=None, on_stage=None,
                max_voxels: int = MAX_VOXELS):
        """points (B, N, 3+C) → dict of outputs: in eval mode feed it to
        ``pointrcnn.post_process``, in train mode (``gt_boxes`` (B, M, 8),
        zero-padded) to ``pvrcnn_loss``. ``roi_draws`` are the RoI sampler's
        draws (``roi_head.sampler_draws``; from the global generator when
        None); ``on_stage(name)`` is called after each of ``self.stages``;
        ``max_voxels`` is the voxel cap (JAX's call parameter and its default)."""
        if self.training and gt_boxes is None:
            raise ValueError("PVRCNN: train mode needs gt_boxes; call .eval() for the eval "
                             "forward")
        mark = on_stage or (lambda name: None)
        cfg = self.model_cfg
        pcr, vs, gs = self.point_cloud_range, self.voxel_size, self.grid_size
        b = points.shape[0]
        xyz = points[..., :3]

        coords, valid = point_voxel_coords(points, pcr, vs, gs)
        vc, vf, vv, vk = voxelize_sparse(points, valid, coords, max_voxels, *gs)
        mark("voxelize")
        bev, scales = self.backbone_3d(vf, vc, vk, vv, (gs[2] + 1, gs[1], gs[0]))
        mark("backbone_3d")
        bev2d = self.backbone_2d(bev)
        mark("backbone_2d")
        cls_preds, box_preds, dir_preds = self.dense_head(bev2d)
        batch_cls, batch_box = self.generate_predicted_boxes(cls_preds, box_preds, dir_preds)
        mark("dense_head")

        kp_idx = p2.furthest_point_sample(xyz, int(cfg.PFE.NUM_KEYPOINTS))
        keypoints = p2.gather_points(xyz, kp_idx)  # (B, K, 3)
        mark("keypoint_fps")

        feats = []
        for name in cfg.PFE.FEATURES_SOURCE:
            if name == "bev":
                feats.append(bilinear_bev(bev, keypoints[..., :2], pcr, vs, BEV_STRIDE))
            elif name == "raw_points":
                all_mask = torch.ones(xyz.shape[:2], dtype=torch.bool, device=xyz.device)
                feats.append(self.vsa[name](xyz, all_mask, points[..., 3:], keypoints))
            else:
                sf, sc, sv, _ = scales[name]
                centres = voxel_centers(sc, BACKBONE_STRIDES[name], pcr, vs)
                centres = torch.where(sv[..., None], centres, 1e6)
                feats.append(self.vsa[name](centres, sv, sf, keypoints))
            mark(f"vsa_{name}")
        kp_raw = torch.cat(feats, dim=-1)  # the features before the fusion
        kp_feats = self.vsa_fusion(kp_raw)
        # PKW: the gradient flows through both factors, as in the reference
        # (point_head_simple's scores are not detached)
        pkw_logits = self.pkw_head(kp_raw)  # (B, K, 1)
        kp_weighted = kp_feats * torch.sigmoid(pkw_logits)
        mark("vsa_fusion")

        out = {"cls_preds": cls_preds, "box_preds": box_preds, "dir_cls_preds": dir_preds,
               "anchors": self.anchors, "keypoints": keypoints, "pkw_logits": pkw_logits}
        nms_cfg = cfg.ROI_HEAD.NMS_CONFIG["TRAIN" if self.training else "TEST"]
        rois, roi_scores, roi_labels, roi_valid = proposal_layer(
            batch_box, batch_cls.reshape(b, -1, self.num_class),
            nms_pre=int(nms_cfg.NMS_PRE_MAXSIZE), nms_post=int(nms_cfg.NMS_POST_MAXSIZE),
            nms_thresh=float(nms_cfg.NMS_THRESH))
        if self.training:
            out["box_cls_labels"], out["box_reg_targets"] = self.anchor_targets(gt_boxes)
            tcfg = cfg.ROI_HEAD.TARGET_CONFIG
            if roi_draws is None:
                roi_draws = sampler_draws(b, rois.shape[1], int(tcfg.ROI_PER_IMAGE), rois.device)
            targets = sample_rois_for_rcnn(rois, roi_scores, roi_labels, gt_boxes, tcfg,
                                           roi_draws)
            rois = targets["rois"]
            roi_scores = targets["roi_scores"]
            roi_labels = targets["roi_labels"]
            roi_valid = torch.ones(rois.shape[:2], dtype=torch.bool, device=rois.device)
            targets["gt_of_rois_src"] = targets["gt_of_rois"]
            targets["gt_of_rois_ct"] = canonical_transform_gt(rois, targets["gt_of_rois"])
            out["roi_targets"] = targets
        mark("proposal")

        r, g3 = rois.shape[1], self.grid ** 3
        grid_pts = roi_grid_points(rois, self.grid).reshape(b, r * g3, 3)
        kp_mask = torch.ones(keypoints.shape[:2], dtype=torch.bool, device=keypoints.device)
        pooled = self.roi_grid_pool(keypoints, kp_mask, kp_weighted, grid_pts)
        pooled = pooled.reshape(b, r, g3 * pooled.shape[-1])
        mark("grid_pool")
        shared = self.roi_shared_fc(pooled)
        rcnn_cls = self.rcnn_cls(shared)
        rcnn_reg = self.rcnn_reg(shared)
        out.update(rcnn_cls=rcnn_cls, rcnn_reg=rcnn_reg, rois=rois, roi_scores=roi_scores,
                   roi_labels=roi_labels, roi_valid=roi_valid)
        if not self.training:
            out["batch_cls_preds"], out["batch_box_preds"] = generate_refined_boxes(
                rois, rcnn_cls, rcnn_reg, self.roi_coder)
        mark("roi_head")
        return out


def pvrcnn_loss(out, gt_boxes, cfg, num_class: int = 1):
    """Stage 1's anchor losses + the PKW segmentation BCE (a keypoint is
    foreground inside a gt box) + the RCNN refinement losses (reference
    pv_rcnn.get_training_loss). Returns (loss, metrics dict of 0-dim
    tensors)."""
    loss1, metrics = grid_detector_loss(out, cfg, num_class)
    gt_valid = gt_boxes.abs().sum(-1) > 0
    seg_target = (points_in_boxes_index(out["keypoints"], gt_boxes[..., :7], gt_valid)
                  >= 0).float()
    pkw_w = float(cfg.POINT_HEAD.LOSS_CONFIG.LOSS_WEIGHTS.point_cls_weight)
    loss_pkw = global_mean(binary_cross_entropy(torch.sigmoid(out["pkw_logits"][..., 0]),
                                                seg_target)) * pkw_w
    rw = cfg.ROI_HEAD.LOSS_CONFIG.LOSS_WEIGHTS
    loss_rcnn_cls, loss_rcnn_reg, loss_corner = roi_head_loss(
        out["rcnn_cls"], out["rcnn_reg"], out["roi_targets"], ResidualCoder(),
        code_weights=list(rw.code_weights), cls_weight=rw.rcnn_cls_weight,
        reg_weight=rw.rcnn_reg_weight, corner_weight=rw.rcnn_corner_weight)
    total = loss1 + loss_pkw + loss_rcnn_cls + loss_rcnn_reg + loss_corner
    metrics = dict(metrics)
    metrics.update(loss=total, pkw_loss=loss_pkw, rcnn_loss_cls=loss_rcnn_cls,
                   rcnn_loss_reg=loss_rcnn_reg + loss_corner)
    return total, metrics
