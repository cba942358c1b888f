"""Voxel R-CNN — port of ``modest_tpu/models/voxel_rcnn.py`` (reference pcdet
detectors/voxel_rcnn.py, roi_heads/voxelrcnn_head.py).

SECOND's stage 1 and its proposals, then a RoI head without keypoints: the
G³ grid points of each proposal take their neighbours straight from the
sparse backbone's scales (x_conv2..x_conv4) by voxel queries
(``ops/pointnet2_stack.py::voxel_query``: searchsorted lookups of the
(2R + 1)³ neighbour keys in a scale's sorted voxel keys), a shared MLP and a
max over the samples. As in the JAX package the head has no dropout
(``DP_RATIO`` is not read) and the train forward's RoI sampler takes its
draws as an argument. Module names follow the JAX package's
(``pool_<scale>``, ``roi_shared_fc``, ``rcnn_cls``, ``rcnn_reg``).
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops import pointnet2 as p2
from ..ops.pointnet2_stack import voxel_query
from .box_coders import ResidualCoder
from .grid_detectors import MAX_VOXELS, TwoStageGridDetector, grid_detector_loss
from .layers import FCHead, SharedMLP
from .pv_rcnn import roi_grid_points, voxel_centers
from .roi_head import generate_refined_boxes, roi_head_loss
from .sparse_conv import BACKBONE_STRIDES, backbone_scale_shapes

SCALE_CHANNELS = {"x_conv1": 16, "x_conv2": 32, "x_conv3": 64, "x_conv4": 64}


class VoxelQueryPool(nn.ModuleList):
    """One sparse scale's neighbour aggregation (reference
    NeighborVoxelSAModuleMSG): per radius a voxel query, the grouped
    (offset to the query, feature) rows zeroed for a query with no hit, a
    shared MLP and a max over the samples; the radii's outputs
    concatenated."""

    def __init__(self, in_channels: int, radii, nsamples, query_ranges, mlps, shape_zyx,
                 stride: int, point_cloud_range, voxel_size):
        super().__init__([SharedMLP(3 + in_channels, [int(c) for c in mlp]) for mlp in mlps])
        self.radii = tuple(float(r) for r in radii)
        self.nsamples = tuple(int(n) for n in nsamples)
        self.query_ranges = tuple(int(q) for q in query_ranges)
        self.shape_zyx = tuple(shape_zyx)
        self.point_cloud_range = tuple(point_cloud_range)
        self.voxel_size = tuple(v * stride for v in voxel_size)
        self.out_channels = sum(int(mlp[-1]) for mlp in mlps)

    def forward(self, queries, feats, keys, centres):
        """queries (B, Q, 3); the scale's features (B, V, C), sorted keys (B,
        V) and voxel centres (B, V, 3) → (B, Q, out_channels)."""
        outs = []
        for radius, nsample, qr, mlp in zip(self.radii, self.nsamples, self.query_ranges, self):
            idx, empty = voxel_query(queries, keys, centres, radius, nsample, qr,
                                     self.shape_zyx, self.point_cloud_range, self.voxel_size)
            b, q, k = idx.shape
            flat = idx.reshape(b, q * k)
            g_xyz = p2.gather_points(centres, flat).reshape(b, q, k, 3) - queries[:, :, None, :]
            g_feat = p2.gather_points(feats, flat).reshape(b, q, k, -1)
            grouped = torch.where(empty[:, :, None, None], 0.0,
                                  torch.cat([g_xyz, g_feat], dim=-1))
            outs.append(mlp(grouped).amax(dim=2))
        return torch.cat(outs, dim=-1)


class VoxelRCNN(TwoStageGridDetector):
    """Voxel R-CNN with one anchor head: ``model.train()`` samples RoIs
    against the gt boxes, ``model.eval()`` gives refined boxes to
    ``pointrcnn.post_process``."""

    def __init__(self, model_cfg, num_class: int, point_cloud_range, voxel_size, grid_size,
                 num_point_features: int = 4):
        super().__init__(model_cfg, num_class, point_cloud_range, voxel_size, grid_size,
                         num_point_features)
        rh = self.model_cfg.ROI_HEAD
        gp = rh.ROI_GRID_POOL
        self.grid = int(gp.GRID_SIZE)
        self.sources = tuple(gp.FEATURES_SOURCE)
        shapes = backbone_scale_shapes(self.grid_size)
        self.grid_pools = nn.ModuleDict()
        for name in self.sources:
            pl = gp.POOL_LAYERS[name]
            self.grid_pools[name] = VoxelQueryPool(
                SCALE_CHANNELS[name], pl.POOL_RADIUS, pl.NSAMPLE, [q[0] for q in pl.QUERY_RANGES],
                pl.MLPS, shapes[name], BACKBONE_STRIDES[name], self.point_cloud_range,
                self.voxel_size)
        pooled = self.grid ** 3 * sum(p.out_channels for p in self.grid_pools.values())
        self.roi_coder = ResidualCoder()
        self.roi_shared_fc = SharedMLP(pooled, rh.SHARED_FC)
        shared = self.roi_shared_fc.out_channels
        self.rcnn_cls = FCHead(shared, rh.CLS_FC, 1)
        self.rcnn_reg = FCHead(shared, rh.REG_FC, self.roi_coder.code_size)
        self.stages = (*self.STAGE_ONE, *(f"pool_{name}" for name in self.sources), "roi_head")

    def forward(self, points, gt_boxes=None, roi_draws=None, on_stage=None,
                max_voxels: int = MAX_VOXELS):
        """points (B, N, 3+C) → dict of outputs: in eval mode feed it to
        ``pointrcnn.post_process``, in train mode (``gt_boxes`` (B, M, 8),
        zero-padded) to ``voxelrcnn_loss``. ``roi_draws`` are the RoI
        sampler's draws (``roi_head.sampler_draws``; from the global generator
        when None); ``on_stage(name)`` is called after each of
        ``self.stages``; ``max_voxels`` as for SECOND."""
        mark = on_stage or (lambda name: None)
        out, _, scales, _, proposals = self.stage_one(points, gt_boxes, mark, max_voxels)
        if self.training:
            proposals = self.sample_rois(out, proposals, gt_boxes, roi_draws)
        rois, roi_scores, roi_labels, roi_valid = proposals
        b, r, g3 = rois.shape[0], rois.shape[1], self.grid ** 3
        grid = roi_grid_points(rois, self.grid).reshape(b, r * g3, 3)
        feats = []
        for name in self.sources:
            sf, sc, _, sk = scales[name]
            centres = voxel_centers(sc, BACKBONE_STRIDES[name], self.point_cloud_range,
                                    self.voxel_size)
            feats.append(self.grid_pools[name](grid, sf, sk, centres))
            mark(f"pool_{name}")
        shared = self.roi_shared_fc(torch.cat(feats, dim=-1).reshape(b, r, -1))
        rcnn_cls = self.rcnn_cls(shared)
        rcnn_reg = self.rcnn_reg(shared)
        out.update(rcnn_cls=rcnn_cls, rcnn_reg=rcnn_reg, rois=rois, roi_scores=roi_scores,
                   roi_labels=roi_labels, roi_valid=roi_valid)
        if not self.training:
            out["batch_cls_preds"], out["batch_box_preds"] = generate_refined_boxes(
                rois, rcnn_cls, rcnn_reg, self.roi_coder)
        mark("roi_head")
        return out


def rcnn_refinement_loss(out, cfg):
    """The RCNN head's classification, regression and corner losses on the
    sampled RoIs (reference roi_head_template.get_loss)."""
    rw = cfg.ROI_HEAD.LOSS_CONFIG.LOSS_WEIGHTS
    return roi_head_loss(out["rcnn_cls"], out["rcnn_reg"], out["roi_targets"], ResidualCoder(),
                         code_weights=list(rw.code_weights), cls_weight=rw.rcnn_cls_weight,
                         reg_weight=rw.rcnn_reg_weight, corner_weight=rw.rcnn_corner_weight)


def voxelrcnn_loss(out, gt_boxes, cfg, num_class: int = 1):
    """Stage 1's anchor losses + the RCNN refinement losses (reference
    voxel_rcnn.get_training_loss). Returns (loss, metrics)."""
    loss1, metrics = grid_detector_loss(out, cfg, num_class)
    loss_cls, loss_reg, loss_corner = rcnn_refinement_loss(out, cfg)
    total = loss1 + loss_cls + loss_reg + loss_corner
    metrics = dict(metrics)
    metrics.update(loss=total, rcnn_loss_cls=loss_cls, rcnn_loss_reg=loss_reg + loss_corner)
    return total, metrics
