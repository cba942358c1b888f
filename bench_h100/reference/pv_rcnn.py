"""PV-RCNN's eval forward and post-processing in plain PyTorch, float32: the
benchmark's reference for ``pv_rcnn_dynamic_obj`` (pcdet
detectors/pv_rcnn.py, backbones_3d/pfe/voxel_set_abstraction.py,
dense_heads/point_head_simple.py, roi_heads/pvrcnn_head.py).

Stage 1 is this reference's SECOND (``grid_detectors.py::GridDetector``:
voxelization, VoxelBackBone8x with its four scales returned, height
compression, BaseBEVBackbone, AnchorHeadSingle) and its proposal layer.
Beside it the plain FPS loop of ``pointnet2.py`` picks ``NUM_KEYPOINTS``
keypoints of the raw points; the voxel set abstraction (VSA) groups each
keypoint's neighbours from the raw points and the backbone's four sparse
scales by masked ball queries taken over blocks of centres
(``pointnet2_stack.py``), two radii a source, each followed by its shared
MLP and a max over the samples, plus the BEV map by bilinear
interpolation; the fusion MLP and the predicted keypoint weight (PKW)
head's sigmoid scale the keypoint features; the RoI-grid head pools them
onto a G³ grid in each proposal by two more ball queries, and its FC
layers refine the proposals; ``post_process`` is PointRCNN's
score-thresholded NMS over the refined boxes.

Departures from pcdet, each as the port has it:
- no dropout in the RoI head (``DP_RATIO`` is not read; pcdet's is off in
  eval anyway);
- each sparse scale is a padded voxel list of static length with a validity
  mask; a padding voxel's centre sits at 1e6 and is masked out of every
  ball besides, where pcdet's stacked ball query sees only active voxels;
- a batch of full scans is padded, not stacked, for the raw points and the
  keypoints (every scan has the same count, so the balls are pcdet's);
- the BEV interpolation clamps the lower cell to [0, W − 2] × [0, H − 2]
  and its weights to [0, 1], where pcdet clamps each corner on its own;
- the shared FC reads the pooled grid point-major (G³ × C), where pcdet
  flattens it channel-major: a permutation of the layer's input columns;
- only the eval forward: train mode changes nothing but the batch norms,
  which then take batch statistics (the benchmark's calibration uses that).
"""
from __future__ import annotations

import torch
from torch import nn

from . import pointnet2 as p2
from .box_coders import ResidualCoder
from .grid_detectors import MAX_VOXELS, GridDetector
from .layers import FCHead, SharedMLP
from .pointnet2_stack import query_and_group_masked
from .pointrcnn import post_process
from .roi_head import generate_refined_boxes, proposal_layer
from .sparse_conv import BACKBONE_STRIDES
from .voxelize import point_voxel_coords, voxelize_sparse

BEV_STRIDE = 8  # the height-compressed map's cell, in voxels


def bilinear_bev(bev, xy, pcr, vs, stride: int):
    """The BEV map (B, C, H, W) at lidar (x, y) points (B, K, 2) → (B, K, C);
    rows are y and columns x, cells of vs·stride, grid index i at the
    sample coordinate (pcdet's ``bilinear_interpolate_torch``)."""
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

    f00, f01 = gather(y0, x0), gather(y0, x0 + 1)
    f10, f11 = gather(y0 + 1, x0), gather(y0 + 1, x0 + 1)
    return (f00 * (1 - tx) + f01 * tx) * (1 - ty) + (f10 * (1 - tx) + f11 * tx) * ty


def voxel_centers(coords_zyx, stride: int, pcr, vs):
    """(B, V, 3) zyx voxel coordinates at ``stride`` → lidar xyz centres."""
    dev = coords_zyx.device
    size = torch.tensor(vs, dtype=torch.float32, device=dev) * stride
    origin = torch.tensor(pcr[:3], dtype=torch.float32, device=dev)
    return (coords_zyx.flip(-1).to(torch.float32) + 0.5) * size + origin


def roi_grid_points(rois, g: int):
    """(B, R, 7) RoIs → (B, R, g³, 3): the centres of a g × g × g grid in each
    RoI, cell (i, j, k) at row i·g² + j·g + k (pcdet
    ``get_global_grid_points_of_roi``)."""
    ar = torch.arange(g, device=rois.device)
    idx = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"), dim=-1).reshape(-1, 3)
    local = ((idx.to(torch.float32) + 0.5) / g - 0.5)[None, None] * rois[:, :, None, 3:6]
    c, s = torch.cos(rois[..., 6])[..., None], torch.sin(rois[..., 6])[..., None]
    gx = local[..., 0] * c - local[..., 1] * s
    gy = local[..., 0] * s + local[..., 1] * c
    return torch.stack([gx, gy, local[..., 2]], dim=-1) + rois[:, :, None, :3]


class VSASource(nn.ModuleList):
    """One set-abstraction source: per radius a masked ball query, a shared
    MLP over the grouped (offset, feature) rows and a max over the samples;
    the radii's outputs concatenated."""

    def __init__(self, in_channels: int, radii, nsamples, mlps):
        super().__init__([SharedMLP(3 + in_channels, [int(c) for c in mlp]) for mlp in mlps])
        self.radii = tuple(float(r) for r in radii)
        self.nsamples = tuple(int(n) for n in nsamples)
        self.out_channels = sum(int(mlp[-1]) for mlp in mlps)

    def forward(self, xyz, xyz_mask, feats, centres):
        outs = []
        for radius, nsample, mlp in zip(self.radii, self.nsamples, self):
            grouped = query_and_group_masked(xyz, xyz_mask, feats, centres, radius, nsample)
            outs.append(mlp(grouped).amax(dim=2))
        return torch.cat(outs, dim=-1)


class PVRCNN(GridDetector):
    """PV-RCNN with one anchor head; its modules carry the port's names, so
    the port's state dict loads into it."""

    GROUPED_ROUTE = False
    POINT_CHANNELS = {"x_conv1": 16, "x_conv2": 32, "x_conv3": 64, "x_conv4": 64}

    def __init__(self, model_cfg, num_class: int, point_cloud_range, voxel_size, grid_size,
                 num_point_features: int = 4):
        super().__init__(model_cfg, num_class, point_cloud_range, voxel_size, grid_size,
                         num_point_features)
        cfg = self.model_cfg
        self.backbone_3d.return_multiscale = True
        pfe = cfg.PFE
        channels = {"raw_points": num_point_features - 3, **self.POINT_CHANNELS}
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

    def forward(self, points, on_stage=None, max_voxels: int = MAX_VOXELS):
        """points (B, N, 3+C) → the eval forward's outputs, for
        ``post_process``; ``keypoint_features`` holds the PKW-weighted
        keypoint features the RoI grid pools."""
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
        cls_preds, box_preds, dir_preds = self.dense_head(self.backbone_2d(bev))
        batch_cls, batch_box = self.generate_predicted_boxes(cls_preds, box_preds, dir_preds)
        mark("dense_head")

        keypoints = p2.gather_points(xyz, p2.furthest_point_sample(xyz, int(cfg.PFE.NUM_KEYPOINTS)))
        mark("keypoint_fps")
        feats = []
        for name in cfg.PFE.FEATURES_SOURCE:
            if name == "bev":
                feats.append(bilinear_bev(bev, keypoints[..., :2], pcr, vs, BEV_STRIDE))
            elif name == "raw_points":
                every = torch.ones(xyz.shape[:2], dtype=torch.bool, device=xyz.device)
                feats.append(self.vsa[name](xyz, every, points[..., 3:], keypoints))
            else:
                sf, sc, sv, _ = scales[name]
                centres = voxel_centers(sc, BACKBONE_STRIDES[name], pcr, vs)
                centres = torch.where(sv[..., None], centres, 1e6)
                feats.append(self.vsa[name](centres, sv, sf, keypoints))
            mark(f"vsa_{name}")
        kp_raw = torch.cat(feats, dim=-1)
        pkw_logits = self.pkw_head(kp_raw)
        kp_weighted = self.vsa_fusion(kp_raw) * torch.sigmoid(pkw_logits)
        mark("vsa_fusion")

        nms_cfg = cfg.ROI_HEAD.NMS_CONFIG.TEST
        rois, roi_scores, roi_labels, roi_valid = proposal_layer(
            batch_box, batch_cls.reshape(b, -1, self.num_class),
            nms_pre=int(nms_cfg.NMS_PRE_MAXSIZE), nms_post=int(nms_cfg.NMS_POST_MAXSIZE),
            nms_thresh=float(nms_cfg.NMS_THRESH))
        mark("proposal")
        r, g3 = rois.shape[1], self.grid ** 3
        grid_pts = roi_grid_points(rois, self.grid).reshape(b, r * g3, 3)
        every = torch.ones(keypoints.shape[:2], dtype=torch.bool, device=keypoints.device)
        pooled = self.roi_grid_pool(keypoints, every, kp_weighted, grid_pts)
        pooled = pooled.reshape(b, r, g3 * pooled.shape[-1])
        mark("grid_pool")
        shared = self.roi_shared_fc(pooled)
        rcnn_cls, rcnn_reg = self.rcnn_cls(shared), self.rcnn_reg(shared)
        refined_cls, refined_box = generate_refined_boxes(rois, rcnn_cls, rcnn_reg,
                                                          self.roi_coder)
        mark("roi_head")
        return {"cls_preds": cls_preds, "keypoints": keypoints, "pkw_logits": pkw_logits,
                "keypoint_features": kp_weighted, "rcnn_cls": rcnn_cls, "rcnn_reg": rcnn_reg,
                "rois": rois, "roi_scores": roi_scores, "roi_labels": roi_labels,
                "roi_valid": roi_valid, "batch_cls_preds": refined_cls,
                "batch_box_preds": refined_box}


def eval_forward(model: PVRCNN, points, max_voxels: int):
    """The eval forward's outputs and the post-processed finals of ``points``."""
    model.eval()
    with torch.inference_mode():
        out = model(points, max_voxels=max_voxels)
        return out, post_process(out, model.model_cfg.POST_PROCESSING)
