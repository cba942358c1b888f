"""Grid detectors: PointPillars and SECOND — port of
``modest_tpu/models/grid_detectors.py`` (reference pcdet PillarVFE →
PointPillarScatter → BaseBEVBackbone → AnchorHeadSingle, and MeanVFE →
VoxelBackBone8x → HeightCompression → BaseBEVBackbone → AnchorHeadSingle).

As in the JAX package, voxelization runs on the device
(``models/voxelize.py``): the pillars' per-point PFN features are
segment-maxed straight into the BEV map, and SECOND's sparse backbone is the
gather-scatter formulation of ``models/sparse_conv.py``. The anchors are
made once on the host (numpy) and live in a non-persistent buffer.

The 2-D maps are NCHW, as pcdet's. The head's outputs are permuted to NHWC
before their reshape, so anchor a of location (y, x) is row (y·fx + x)·na + a,
the JAX package's location-major order. Module names are pcdet's
(``vfe.pfn_layers.k.{linear,norm}``, ``backbone_3d.conv*``,
``backbone_2d.{blocks,deblocks}``, ``dense_head.conv_{cls,box,dir_cls}``).
Multi-class anchor sets and ``AnchorHeadMulti`` take the grouped head of
``models/anchor_head_multi.py``; SECOND takes ``VoxelResBackBone8x`` where
the config names it; the ATSS assigner and multi-class NMS are here.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..ops.box_torch import limit_period
from ..ops.iou3d import boxes_iou3d, boxes_iou_bev, multi_classes_nms, nms_bev
from ..parallel.mesh import global_batch
from ..utils.config import Config
from .box_coders import ResidualCoder
from .layers import BatchNorm2d, Conv2d, MaskedBatchNorm
from .losses import sigmoid_focal_loss, weighted_smooth_l1
from .roi_head import canonical_transform_gt, proposal_layer, sample_rois_for_rcnn, sampler_draws
from .voxelize import pillar_stats, point_voxel_coords, scatter_max_bev, voxelize_sparse

MAX_VOXELS = 16000  # the JAX GridDetector's default, used in train and eval alike


# ---------------------------------------------------------------------------
# anchors and targets (reference target_assigner/)
# ---------------------------------------------------------------------------


def generate_anchors(anchor_cfg, grid_size, point_cloud_range):
    """(A, 7) float32 anchors, location-major (fy, fx, na), and the feature
    map shape (fy, fx)."""
    per_cfg = []
    fmaps = []
    for cfg in anchor_cfg:
        stride = cfg["feature_map_stride"]
        fx = grid_size[0] // stride
        fy = grid_size[1] // stride
        pcr = point_cloud_range
        if cfg.get("align_center", False):
            x_stride = (pcr[3] - pcr[0]) / fx
            y_stride = (pcr[4] - pcr[1]) / fy
            x_off, y_off = x_stride / 2, y_stride / 2
        else:
            x_stride = (pcr[3] - pcr[0]) / (fx - 1)
            y_stride = (pcr[4] - pcr[1]) / (fy - 1)
            x_off = y_off = 0.0
        xs = pcr[0] + x_off + x_stride * np.arange(fx)
        ys = pcr[1] + y_off + y_stride * np.arange(fy)
        sizes = np.asarray(cfg["anchor_sizes"], np.float32)
        rots = np.asarray(cfg["anchor_rotations"], np.float32)
        heights = np.asarray(cfg["anchor_bottom_heights"], np.float32)
        out = np.zeros((fy, fx, len(heights), len(sizes), len(rots), 7), np.float32)
        out[..., 0] = xs[None, :, None, None, None]
        out[..., 1] = ys[:, None, None, None, None]
        out[..., 2] = heights[None, None, :, None, None]
        out[..., 3:6] = sizes[None, None, None, :, None, :]
        out[..., 6] = rots[None, None, None, None, :]
        out[..., 2] += out[..., 5] / 2  # bottom → center z
        per_cfg.append(out.reshape(fy, fx, -1, 7))
        fmaps.append((fy, fx))
    if len(per_cfg) == 1:
        return per_cfg[0].reshape(-1, 7), fmaps[0]
    assert len(set(fmaps)) == 1, f"mixed feature_map_stride: {fmaps}"
    return np.concatenate(per_cfg, axis=2).reshape(-1, 7), fmaps[0]


def aligned_bev_iou(boxes_a, boxes_b):
    """Nearest-axis-aligned BEV IoU (reference box_utils.py:287-313):
    (..., N, 7), (..., M, 7) → (..., N, M)."""

    def aligned(boxes):
        rot = limit_period(boxes[..., 6], 0.5, math.pi).abs()
        dims = torch.where((rot < math.pi / 4)[..., None], boxes[..., [3, 4]],
                           boxes[..., [4, 3]])
        return torch.cat([boxes[..., 0:2] - dims / 2, boxes[..., 0:2] + dims / 2], dim=-1)

    a, b = aligned(boxes_a)[..., :, None, :], aligned(boxes_b)[..., None, :, :]
    x_min = torch.maximum(a[..., 0], b[..., 0])
    x_max = torch.minimum(a[..., 2], b[..., 2])
    y_min = torch.maximum(a[..., 1], b[..., 1])
    y_max = torch.minimum(a[..., 3], b[..., 3])
    inter = torch.clamp_min(x_max - x_min, 0) * torch.clamp_min(y_max - y_min, 0)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / torch.clamp_min(area_a + area_b - inter, 1e-6)


def single_head_anchor_setup(anchor_cfg, grid_size, point_cloud_range):
    """Anchors and per-anchor match settings of a (possibly multi-class)
    AnchorHeadSingle, location-major. The anchor configs are in
    ``CLASS_NAMES`` order (class id = position + 1). Returns (anchors (A, 7),
    anchors per location, matched_thr, unmatched_thr, anchor_cls): scalars
    and None for one config, per-anchor (A,) arrays otherwise."""
    anchors, fmap = generate_anchors(anchor_cfg, grid_size, point_cloud_range)
    na_list = [len(c["anchor_sizes"]) * len(c["anchor_rotations"])
               * len(c["anchor_bottom_heights"]) for c in anchor_cfg]
    if len(anchor_cfg) == 1:
        c = anchor_cfg[0]
        return (anchors, na_list[0], float(c["matched_threshold"]),
                float(c["unmatched_threshold"]), None)

    def per_anchor(values, dtype):
        loc = np.concatenate([np.full(n, v, dtype) for v, n in zip(values, na_list)])
        return np.tile(loc, fmap[0] * fmap[1])

    return (anchors, sum(na_list),
            per_anchor([c["matched_threshold"] for c in anchor_cfg], np.float32),
            per_anchor([c["unmatched_threshold"] for c in anchor_cfg], np.float32),
            per_anchor(range(1, len(anchor_cfg) + 1), np.int32))


@torch.no_grad()
def assign_anchor_targets(anchors, gt_boxes, box_coder, matched_thr, unmatched_thr,
                          anchor_cls=None):
    """AxisAlignedTargetAssigner over the batch.

    anchors (A, 7); gt_boxes (B, M, 8), zero rows padding. The thresholds are
    scalars or per-anchor (A,) tensors; ``anchor_cls`` (A,), when given,
    matches each anchor only to gt boxes of its class (the reference assigns
    class by class; masking the overlaps is the same). Returns labels (B, A)
    int64 (-1 ignore, 0 background, class id), reg_targets (B, A, code) and
    reg_weights (B, A)."""
    gt_valid = gt_boxes.abs().sum(-1) > 0  # (B, M)
    cls = gt_boxes[..., 7].long()
    ov = aligned_bev_iou(anchors, gt_boxes[..., :7])  # (B, A, M)
    pair_ok = gt_valid[:, None, :]
    if anchor_cls is not None:
        pair_ok = pair_ok & (cls[:, None, :] == anchor_cls[None, :, None])
    ov = torch.where(pair_ok, ov, -1.0)
    a2g_max = ov.amax(dim=2)
    a2g_arg = ov.argmax(dim=2)  # the first maximum, as jnp.argmax
    g2a_max = torch.where(gt_valid, ov.amax(dim=1), -1.0)
    g2a_max = torch.where(g2a_max == 0, -1.0, g2a_max)  # an empty gt never forces
    # force-match only against real gt columns with a positive best overlap
    force = (((ov == g2a_max[:, None, :]) & pair_ok & (g2a_max > 0)[:, None, :]).any(dim=2)
             & (a2g_max > 0))
    pos = a2g_max >= matched_thr
    bg = a2g_max < unmatched_thr
    cls_of_anchor = torch.gather(cls, 1, a2g_arg)
    labels = torch.where(force | pos, cls_of_anchor,
                         torch.where(bg, 0, -1).to(cls_of_anchor.dtype))
    labels = torch.where(gt_valid.any(dim=1, keepdim=True), labels, 0)
    matched = torch.gather(gt_boxes[..., :7], 1, a2g_arg[..., None].expand(-1, -1, 7))
    reg_targets = box_coder.encode(matched, anchors.expand_as(matched))
    fg = labels > 0
    reg_targets = torch.where(fg[..., None], reg_targets, 0.0)
    return labels, reg_targets, fg.float()


@torch.no_grad()
def assign_targets_atss(anchors, gt_boxes, box_coder, topk: int, match_height: bool = False):
    """ATSS target assigner (arXiv 1912.02424; reference
    atss_target_assigner.py:75-141) over the batch, as the JAX package's
    ``assign_targets_atss``: per gt box its ``topk`` anchors of nearest
    centre are candidates, positive at or above the mean + std (Bessel) of
    their IoUs and with the centre inside the box's BEV rectangle (the
    reference's local (x, y) against (dy, dx)/2, sizes swapped, kept); an
    anchor that several boxes claim keeps the one of highest IoU, and each
    box claims its best-IoU anchor (the last box wins a collision). No
    ignore band. Returns (labels (B, A), reg_targets (B, A, code),
    reg_weights (B, A))."""
    iou_fn = boxes_iou3d if match_height else boxes_iou_bev
    b, m = gt_boxes.shape[:2]
    num_a = anchors.shape[0]
    k = min(int(topk), num_a)
    dev = anchors.device
    gt_valid = gt_boxes.abs().sum(-1) > 0  # (B, M)
    cls = gt_boxes[..., 7].long()
    ious = iou_fn(anchors.expand(b, -1, -1), gt_boxes[..., :7])  # (B, A, M)
    ious = torch.where(gt_valid[:, None, :], ious, 0.0)

    dist = torch.linalg.norm(anchors[None, :, None, :3] - gt_boxes[:, None, :, :3], dim=-1)
    # the k nearest, ties to the lower anchor index (lax.top_k of -dist)
    topk_idx = torch.sort(-dist.transpose(1, 2), dim=-1, descending=True,
                          stable=True).indices[..., :k]  # (B, M, K)
    cand = torch.gather(ious.transpose(1, 2), 2, topk_idx)  # (B, M, K)
    thresh = cand.mean(-1) + cand.std(-1) + 1e-6
    is_pos = cand >= thresh[..., None]

    cand_xy = (torch.gather(anchors[:, :2].expand(b, -1, -1), 1,
                            topk_idx.reshape(b, -1, 1).expand(-1, -1, 2)).reshape(b, m, k, 2)
               - gt_boxes[:, :, None, :2])
    c, s = torch.cos(-gt_boxes[..., 6])[..., None], torch.sin(-gt_boxes[..., 6])[..., None]
    x_loc = cand_xy[..., 0] * c - cand_xy[..., 1] * s
    y_loc = cand_xy[..., 0] * s + cand_xy[..., 1] * c
    in_gt = ((x_loc.abs() <= gt_boxes[..., 4:5] / 2)
             & (y_loc.abs() <= gt_boxes[..., 3:4] / 2))
    is_pos = is_pos & in_gt  # (B, M, K)

    allowed = torch.zeros(b, m, num_a, dtype=torch.int32, device=dev).scatter_reduce(
        2, topk_idx, is_pos.to(torch.int32), "amax").transpose(1, 2)  # (B, A, M)
    ious_inf = torch.where((allowed > 0) & gt_valid[:, None, :], ious, float("-inf"))
    a2g_val = ious_inf.amax(dim=2)
    a2g_arg = ious_inf.argmax(dim=2)  # the first maximum, as jnp.argmax

    best_anchor = ious.argmax(dim=1)  # (B, M)
    gt_ids = torch.where(gt_valid, torch.arange(m, device=dev), -1)
    forced = torch.full((b, num_a), -1, dtype=torch.int64, device=dev).scatter_reduce(
        1, best_anchor, gt_ids, "amax")
    idx = torch.where(forced >= 0, forced, a2g_arg)
    val = torch.where(forced >= 0, torch.gather(ious, 2, forced.clamp_min(0)[..., None])[..., 0],
                      a2g_val)
    labels = torch.where(val > float("-inf"), torch.gather(cls, 1, idx), 0)
    fg = labels > 0
    matched = torch.gather(gt_boxes[..., :7], 1, idx[..., None].expand(-1, -1, 7))
    reg_targets = box_coder.encode(matched, anchors.expand_as(matched))
    reg_targets = torch.where(fg[..., None], reg_targets, 0.0)
    return labels, reg_targets, fg.float()


# ---------------------------------------------------------------------------
# network modules
# ---------------------------------------------------------------------------


class PFNLayer(nn.Module):
    """Linear (no bias) → masked batch norm → ReLU over the points (pcdet's
    PFNLayer keys ``linear`` and ``norm``)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.linear = nn.Linear(in_channels, out_channels, bias=False)
        self.norm = MaskedBatchNorm(out_channels)

    def forward(self, x, valid):
        return torch.relu(self.norm(self.linear(x), valid))


class PillarVFE(nn.Module):
    """Point-wise pillar features (reference PillarVFE) and the dense BEV
    scatter: (B, N, C) points → (B, F, ny, nx). The layers stack as the JAX
    package's ``PillarFeatureNet`` does; the batch norm's statistics cover
    every in-range point of the batch."""

    def __init__(self, num_point_features: int, num_filters, voxel_size, point_cloud_range,
                 nx: int, ny: int, use_absolute_xyz: bool = True, with_distance: bool = False):
        super().__init__()
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.nx, self.ny = nx, ny
        self.use_absolute_xyz, self.with_distance = use_absolute_xyz, with_distance
        c_in = (num_point_features if use_absolute_xyz else num_point_features - 3) + 6
        c_in += int(with_distance)
        layers = []
        for c in num_filters:
            layers.append(PFNLayer(c_in, c))
            c_in = c
        self.pfn_layers = nn.ModuleList(layers)
        self.num_bev_features = c_in

    def forward(self, points):
        vs, pcr = self.voxel_size, self.point_cloud_range
        coords, valid = point_voxel_coords(points, pcr, (vs[0], vs[1], pcr[5] - pcr[2]),
                                           (self.nx, self.ny, 1))
        _, mean, key = pillar_stats(points, valid, coords[..., :2], self.nx, self.ny)
        xyz = points[..., :3]
        centers_x = coords[..., 0].to(points.dtype) * vs[0] + (vs[0] / 2 + pcr[0])
        centers_y = coords[..., 1].to(points.dtype) * vs[1] + (vs[1] / 2 + pcr[1])
        centers_z = (pcr[5] - pcr[2]) / 2 + pcr[2]
        f_center = torch.stack([points[..., 0] - centers_x, points[..., 1] - centers_y,
                                points[..., 2] - centers_z], dim=-1)
        feats = [points if self.use_absolute_xyz else points[..., 3:], xyz - mean, f_center]
        if self.with_distance:
            feats.append(torch.linalg.norm(xyz, dim=-1, keepdim=True))
        x = torch.where(valid[..., None], torch.cat(feats, dim=-1), 0.0)
        for layer in self.pfn_layers:
            x = layer(x, valid)
        return scatter_max_bev(x, key, valid, self.nx, self.ny)


def _conv_bn_relu(c_in, c_out, stride=1, padding=1):
    return [Conv2d(c_in, c_out, 3, stride=stride, padding=padding),
            BatchNorm2d(c_out), nn.ReLU()]


class BaseBEVBackbone(nn.Module):
    """reference backbones_2d/base_bev_backbone.py: per level a strided conv
    and ``LAYER_NUMS[i]`` convs (conv, BN, ReLU each), an up- or
    down-sampling deblock, and the deblocks' outputs concatenated."""

    def __init__(self, cfg, in_channels: int):
        super().__init__()
        blocks, deblocks = [], []
        c_in = in_channels
        for i, n_layers in enumerate(cfg.LAYER_NUMS):
            nf = int(cfg.NUM_FILTERS[i])
            layers = [nn.ZeroPad2d(1), *_conv_bn_relu(c_in, nf, int(cfg.LAYER_STRIDES[i]), 0)]
            for _ in range(int(n_layers)):
                layers += _conv_bn_relu(nf, nf)
            blocks.append(nn.Sequential(*layers))
            s = float(cfg.UPSAMPLE_STRIDES[i])
            nu = int(cfg.NUM_UPSAMPLE_FILTERS[i])
            if s >= 1:
                up = nn.ConvTranspose2d(nf, nu, int(s), stride=int(s), bias=False)
            else:
                inv = int(round(1 / s))
                up = Conv2d(nf, nu, inv, stride=inv)
            deblocks.append(nn.Sequential(up, BatchNorm2d(nu), nn.ReLU()))
            c_in = nf
        self.blocks = nn.ModuleList(blocks)
        self.deblocks = nn.ModuleList(deblocks)
        self.num_bev_features = sum(int(c) for c in cfg.NUM_UPSAMPLE_FILTERS)

    def forward(self, x):
        ups = []
        for block, deblock in zip(self.blocks, self.deblocks):
            x = block(x)
            ups.append(deblock(x))
        return torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]


class AnchorHeadSingle(nn.Module):
    """1x1 conv heads over the BEV map (reference anchor_head_single.py);
    outputs (B, H·W·na, num_class), (B, H·W·na, 7), (B, H·W·na, bins)."""

    def __init__(self, in_channels: int, num_class: int, num_anchors_per_loc: int,
                 code_size: int, num_dir_bins: int = 2, use_dir: bool = True):
        super().__init__()
        na = num_anchors_per_loc
        self.num_class, self.code_size, self.num_dir_bins = num_class, code_size, num_dir_bins
        self.conv_cls = nn.Conv2d(in_channels, na * num_class, 1)
        self.conv_box = nn.Conv2d(in_channels, na * code_size, 1)
        self.conv_dir_cls = nn.Conv2d(in_channels, na * num_dir_bins, 1) if use_dir else None

    def forward(self, bev):
        b = bev.shape[0]

        def rows(y, width):  # NCHW → NHWC → location-major anchor rows
            return y.permute(0, 2, 3, 1).reshape(b, -1, width)

        cls = rows(self.conv_cls(bev), self.num_class)
        box = rows(self.conv_box(bev), self.code_size)
        dir_cls = (rows(self.conv_dir_cls(bev), self.num_dir_bins)
                   if self.conv_dir_cls is not None else None)
        return cls, box, dir_cls


# the sparse backbones each voxel detector takes (VoxelBackBone8x where unlisted)
SPARSE_BACKBONES = {"SECONDNet": ("VoxelBackBone8x", "VoxelResBackBone8x"),
                    "PartA2": ("UNetV2",), "PartA2Net": ("UNetV2",)}


class GridDetector(nn.Module):
    """PointPillar / SECONDNet. ``model.train()`` selects the train branch
    (targets against the gt boxes, batch norms on batch statistics),
    ``model.eval()`` the eval one (decoded boxes).

    As in the JAX package, an ``AnchorHeadMulti`` config or a multi-class
    anchor set goes through the grouped head (``models/anchor_head_multi.py``:
    class-major anchors, per-class thresholds, the box coder of
    ``BOX_CODER_CONFIG``, ``class_names`` needed); one anchor config takes
    the single head, matched by ``TARGET_ASSIGNER_CONFIG.NAME``
    (AxisAlignedTargetAssigner or ATSS). The two-stage detectors below set
    ``GROUPED_ROUTE`` off: their stage 1 is always one head over
    location-major anchors with per-anchor thresholds and classes, and the
    7-dim coder, whatever the config names (the JAX package's
    ``single_head_anchor_setup``)."""

    GROUPED_ROUTE = True

    def __init__(self, model_cfg, num_class: int, point_cloud_range, voxel_size, grid_size,
                 num_point_features: int = 4, class_names=None):
        super().__init__()
        self.model_cfg = cfg = Config(model_cfg)
        self.num_class = num_class
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.grid_size = gs = tuple(int(v) for v in grid_size)
        head = cfg.DENSE_HEAD
        acfgs = [c.to_dict() for c in head.ANCHOR_GENERATOR_CONFIG]
        tac = head.get("TARGET_ASSIGNER_CONFIG", None) or {}
        self.assigner = "AxisAlignedTargetAssigner"
        code_size, sincos = 7, False
        self.use_multihead = self.GROUPED_ROUTE and (
            head.get("NAME", "AnchorHeadSingle") == "AnchorHeadMulti" or len(acfgs) > 1)
        if self.GROUPED_ROUTE:
            self.assigner = str(tac.get("NAME", "AxisAlignedTargetAssigner"))
            if self.assigner not in ("AxisAlignedTargetAssigner", "ATSS"):
                raise NotImplementedError(f"target assigner {self.assigner}")
            self.atss_topk = int(tac.get("TOPK", 9))
            self.match_height = bool(tac.get("MATCH_HEIGHT", False))
            # BOX_CODER_CONFIG under TARGET_ASSIGNER_CONFIG (the cbgs configs) or DENSE_HEAD
            bcc = tac.get("BOX_CODER_CONFIG", None) or head.get("BOX_CODER_CONFIG", None) or {}
            code_size = int(bcc.get("code_size", 7))
            sincos = bool(bcc.get("encode_angle_by_sincos", False))
        self.box_coder = ResidualCoder(code_size, sincos)

        if cfg.NAME == "PointPillar":
            self.vfe = PillarVFE(num_point_features, cfg.VFE.NUM_FILTERS, self.voxel_size,
                                 self.point_cloud_range, gs[0], gs[1],
                                 use_absolute_xyz=bool(cfg.VFE.get("USE_ABSLOTE_XYZ", True)),
                                 with_distance=bool(cfg.VFE.get("WITH_DISTANCE", False)))
            bev_channels = self.vfe.num_bev_features
            self.stages = ("vfe", "backbone_2d", "dense_head")
        else:
            from .sparse_conv import SparseUNet, VoxelBackBone8x, VoxelResBackBone8x

            name = cfg.get("BACKBONE_3D", {}).get("NAME", "VoxelBackBone8x")
            if name not in SPARSE_BACKBONES.get(cfg.NAME, ("VoxelBackBone8x",)):
                raise NotImplementedError(f"sparse backbone {name} is not ported for {cfg.NAME}")
            backbone = {"UNetV2": SparseUNet, "VoxelResBackBone8x": VoxelResBackBone8x}.get(
                name, VoxelBackBone8x)
            self.backbone_3d = backbone(num_point_features)
            nz = gs[2] + 1  # z padded like spconv
            for pad in (1, 1, 0):  # conv2/3/4 (kernel 3, stride 2), then conv_out
                nz = (nz + 2 * pad - 3) // 2 + 1
            bev_channels = 128 * ((nz - 3) // 2 + 1)
            self.stages = ("voxelize", "backbone_3d", "backbone_2d", "dense_head")
        self.num_bev_features = bev_channels
        self.backbone_2d = BaseBEVBackbone(cfg.BACKBONE_2D, bev_channels)
        if self.use_multihead:
            from .anchor_head_multi import AnchorHeadMulti

            if not class_names:
                raise ValueError(f"{cfg.NAME} with a grouped anchor head needs class_names")
            self.dense_head = AnchorHeadMulti(head, class_names, gs, self.point_cloud_range,
                                              self.backbone_2d.num_bev_features, code_size,
                                              sincos)
            self.register_buffer("anchors", self.dense_head.anchors.clone(), persistent=False)
            return
        anchors, na, *match = single_head_anchor_setup(acfgs, gs, self.point_cloud_range)
        self.register_buffer("anchors", torch.from_numpy(anchors), persistent=False)
        # per-anchor arrays for a multi-class set; scalars and None for one class
        for key, value in zip(("matched_thr", "unmatched_thr", "anchor_cls"), match):
            if isinstance(value, np.ndarray):
                self.register_buffer(key, torch.from_numpy(value), persistent=False)
            else:
                setattr(self, key, value)
        self.dense_head = AnchorHeadSingle(
            self.backbone_2d.num_bev_features, num_class, na, self.box_coder.code_size,
            num_dir_bins=int(head.get("NUM_DIR_BINS", 2)),
            use_dir=bool(head.get("USE_DIRECTION_CLASSIFIER", True)))

    def anchor_targets(self, gt_boxes):
        """The single head's (labels, reg_targets) for ``gt_boxes``."""
        if self.assigner == "ATSS":
            labels, reg_targets, _ = assign_targets_atss(
                self.anchors, gt_boxes, self.box_coder, self.atss_topk, self.match_height)
        else:
            labels, reg_targets, _ = assign_anchor_targets(
                self.anchors, gt_boxes, self.box_coder, self.matched_thr, self.unmatched_thr,
                self.anchor_cls)
        return labels, reg_targets

    def head_forward(self, bev2d, gt_boxes):
        """The dense head on the BEV map: its predictions and anchors, and in
        train mode its targets."""
        if self.use_multihead:
            return self.dense_head(bev2d, gt_boxes if self.training else None)
        cls_preds, box_preds, dir_preds = self.dense_head(bev2d)
        out = {"cls_preds": cls_preds, "box_preds": box_preds, "dir_cls_preds": dir_preds,
               "anchors": self.anchors}
        if self.training:
            out["box_cls_labels"], out["box_reg_targets"] = self.anchor_targets(gt_boxes)
        return out

    def forward(self, points, gt_boxes=None, on_stage=None, max_voxels: int = MAX_VOXELS):
        """points (B, N, 3+C) → dict of outputs: in eval mode feed it to
        ``grid_post_process``, in train mode (``gt_boxes`` (B, M, 8),
        zero-padded; (B, M, 10) with velocity for a 9-code head) to
        ``grid_detector_loss``. ``on_stage(name)``, when given, is called
        after each stage of ``self.stages``; ``max_voxels`` is SECOND's voxel
        cap (JAX's call parameter and its default)."""
        if self.training and gt_boxes is None:
            raise ValueError("GridDetector: train mode needs gt_boxes; call .eval() for the "
                             "eval forward")
        mark = on_stage or (lambda name: None)
        if self.model_cfg.NAME == "PointPillar":
            bev = self.vfe(points)
            mark("vfe")
        else:
            gs = self.grid_size
            coords, valid = point_voxel_coords(points, self.point_cloud_range, self.voxel_size,
                                               gs)
            vc, vf, vv, vk = voxelize_sparse(points, valid, coords, max_voxels, *gs)
            mark("voxelize")
            bev = self.backbone_3d(vf, vc, vk, vv, (gs[2] + 1, gs[1], gs[0]))
            mark("backbone_3d")
        bev2d = self.backbone_2d(bev)
        mark("backbone_2d")
        out = self.head_forward(bev2d, gt_boxes)
        if not self.training:
            out["batch_cls_preds"], out["batch_box_preds"] = self.generate_predicted_boxes(
                out["cls_preds"], out["box_preds"], out["dir_cls_preds"])
        mark("dense_head")
        return out

    def generate_predicted_boxes(self, cls_preds, box_preds, dir_preds):
        """Anchor decode and the direction-bin snap."""
        boxes = self.box_coder.decode(box_preds, self.anchors[None].expand(
            *box_preds.shape[:2], -1))
        if dir_preds is not None:
            head = self.model_cfg.DENSE_HEAD
            dir_offset = float(head.DIR_OFFSET)
            period = 2 * math.pi / int(head.NUM_DIR_BINS)
            dir_labels = dir_preds.argmax(dim=-1)
            dir_rot = limit_period(boxes[..., 6] - dir_offset, float(head.DIR_LIMIT_OFFSET),
                                   period)
            heading = dir_rot + dir_offset + period * dir_labels.to(boxes.dtype)
            boxes = torch.cat([boxes[..., :6], heading[..., None], boxes[..., 7:]], dim=-1)
        return cls_preds, boxes


class TwoStageGridDetector(GridDetector):
    """SECOND's stage 1 and its proposals, the base of the two-stage voxel
    detectors (SECOND-IoU, Voxel R-CNN, Part-A2): ``stage_one`` runs the
    voxelization, the sparse backbone, the BEV backbone, the anchor head and
    the proposal layer (``ROI_HEAD.NMS_CONFIG``, TRAIN or TEST by the mode),
    and in train mode the anchor targets."""

    GROUPED_ROUTE = False
    STAGE_ONE = ("voxelize", "backbone_3d", "backbone_2d", "dense_head", "proposal")

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.backbone_3d.return_multiscale = True

    def stage_one(self, points, gt_boxes, mark, max_voxels: int):
        """Returns (out, voxels (coords, feats, valid, keys), the sparse
        backbone's output after the BEV map, the BEV backbone's map, the
        proposals (rois, roi_scores, roi_labels, roi_valid))."""
        if self.training and gt_boxes is None:
            raise ValueError(f"{self.model_cfg.NAME}: train mode needs gt_boxes; call .eval() "
                             "for the eval forward")
        gs = self.grid_size
        coords, valid = point_voxel_coords(points, self.point_cloud_range, self.voxel_size, gs)
        voxels = voxelize_sparse(points, valid, coords, max_voxels, *gs)
        mark("voxelize")
        vc, vf, vv, vk = voxels
        bev, extra = self.backbone_3d(vf, vc, vk, vv, (gs[2] + 1, gs[1], gs[0]))
        mark("backbone_3d")
        bev2d = self.backbone_2d(bev)
        mark("backbone_2d")
        out = self.head_forward(bev2d, gt_boxes)
        batch_cls, batch_box = self.generate_predicted_boxes(
            out["cls_preds"], out["box_preds"], out["dir_cls_preds"])
        mark("dense_head")
        nms_cfg = self.model_cfg.ROI_HEAD.NMS_CONFIG["TRAIN" if self.training else "TEST"]
        proposals = proposal_layer(
            batch_box, batch_cls.reshape(points.shape[0], -1, self.num_class),
            nms_pre=int(nms_cfg.NMS_PRE_MAXSIZE), nms_post=int(nms_cfg.NMS_POST_MAXSIZE),
            nms_thresh=float(nms_cfg.NMS_THRESH))
        mark("proposal")
        return out, voxels, extra, bev2d, proposals

    def sample_rois(self, out, proposals, gt_boxes, roi_draws):
        """Train mode: the RoI sampler's RoIs and their targets (in
        ``out["roi_targets"]``); ``roi_draws`` from the global generator when
        None. Returns (rois, roi_scores, roi_labels, roi_valid)."""
        rois, roi_scores, roi_labels, _ = proposals
        tcfg = self.model_cfg.ROI_HEAD.TARGET_CONFIG
        if roi_draws is None:
            roi_draws = sampler_draws(rois.shape[0], rois.shape[1], int(tcfg.ROI_PER_IMAGE),
                                      rois.device)
        targets = sample_rois_for_rcnn(rois, roi_scores, roi_labels, gt_boxes, tcfg, roi_draws)
        rois = targets["rois"]
        targets["gt_of_rois_src"] = targets["gt_of_rois"]
        targets["gt_of_rois_ct"] = canonical_transform_gt(rois, targets["gt_of_rois"])
        out["roi_targets"] = targets
        return (rois, targets["roi_scores"], targets["roi_labels"],
                torch.ones(rois.shape[:2], dtype=torch.bool, device=rois.device))


def grid_detector_loss(out, cfg, num_class: int = 1):
    """AnchorHeadTemplate losses (reference anchor_head_template.py:101-223):
    focal classification over ``num_class`` columns, smooth-L1 box
    regression with the sin(a − b) heading trick (none for a (cos, sin)
    coder), direction cross-entropy. Returns (loss, metrics)."""
    lw = cfg.DENSE_HEAD.LOSS_CONFIG.LOSS_WEIGHTS
    cls_preds, box_preds = out["cls_preds"], out["box_preds"]
    labels, reg_targets = out["box_cls_labels"], out["box_reg_targets"]
    anchors = out["anchors"][None]
    if cls_preds.shape[-1] != num_class:
        raise ValueError(f"cls_preds have {cls_preds.shape[-1]} class columns, the loss was "
                         f"asked for num_class={num_class}")

    positives = labels > 0
    negatives = labels == 0
    pos_norm = torch.clamp_min(positives.sum(1, keepdim=True).float(), 1.0)
    cls_w = (negatives.float() + positives.float()) / pos_norm
    reg_w = positives.float() / pos_norm
    one_hot = nn.functional.one_hot(labels.long().clamp_min(0), num_class + 1)[..., 1:].float()
    b = global_batch(cls_preds.shape[0])  # the per-sample sums are averaged over the global batch
    cls_loss = sigmoid_focal_loss(cls_preds, one_hot, cls_w).sum() / b * lw.cls_weight

    if out.get("box_coder_sincos", False):
        bp, bt = box_preds, reg_targets  # the (cos, sin) residuals need no trick
    else:
        sin_pred = torch.sin(box_preds[..., 6:7]) * torch.cos(reg_targets[..., 6:7])
        sin_tgt = torch.cos(box_preds[..., 6:7]) * torch.sin(reg_targets[..., 6:7])
        bp = torch.cat([box_preds[..., :6], sin_pred, box_preds[..., 7:]], dim=-1)
        bt = torch.cat([reg_targets[..., :6], sin_tgt, reg_targets[..., 7:]], dim=-1)
    loc_loss = (weighted_smooth_l1(bp, bt, reg_w, list(lw.code_weights)).sum() / b
                * lw.loc_weight)
    total = cls_loss + loc_loss
    metrics = {"rpn_loss_cls": cls_loss, "rpn_loss_loc": loc_loss}
    if out.get("dir_cls_preds") is not None:
        head = cfg.DENSE_HEAD
        bins = int(head.NUM_DIR_BINS)
        # the grouped head hands over the matched gt heading itself
        rot_gt = out["box_gt_heading"] if "box_gt_heading" in out \
            else reg_targets[..., 6] + anchors[..., 6]
        offset_rot = limit_period(rot_gt - float(head.DIR_OFFSET), 0, 2 * math.pi)
        dir_targets = torch.floor(offset_rot / (2 * math.pi / bins)).long().clamp(0, bins - 1)
        logp = torch.log_softmax(out["dir_cls_preds"], dim=-1)
        ce = -torch.gather(logp, -1, dir_targets[..., None])[..., 0]
        dir_w = positives.float()
        dir_w = dir_w / torch.clamp_min(dir_w.sum(-1, keepdim=True), 1.0)
        dir_loss = (ce * dir_w).sum() / b * lw.dir_weight
        total = total + dir_loss
        metrics["rpn_loss_dir"] = dir_loss
    metrics["loss"] = total
    return total, metrics


def grid_post_process(out, post_cfg):
    """Score-thresholded greedy NMS over the decoded anchors, batched and
    padded, as the JAX package's ``grid_post_process``. One route takes each
    anchor's best class: the ``NMS_PRE_MAXSIZE`` best scores (ties to the
    lower anchor index, as ``lax.top_k``), anchors at or below
    ``SCORE_THRESH`` never kept, (B, NMS_POST_MAXSIZE) slots.
    ``MULTI_CLASSES_NMS`` runs ``multi_classes_nms``: every class over every
    anchor, (B, C·NMS_POST_MAXSIZE) slots in class order. Returns boxes (all
    the decoded columns) / scores / labels and validity."""
    nms_cfg = post_cfg.NMS_CONFIG
    cls, boxes = out["batch_cls_preds"], out["batch_box_preds"]
    width = boxes.shape[-1]
    if nms_cfg.get("MULTI_CLASSES_NMS", False):
        scores, labels, idx, mask = multi_classes_nms(
            torch.sigmoid(cls), boxes, float(nms_cfg.NMS_THRESH),
            score_thresh=float(post_cfg.SCORE_THRESH),
            pre_maxsize=int(nms_cfg.NMS_PRE_MAXSIZE), post_maxsize=int(nms_cfg.NMS_POST_MAXSIZE))
        return {"boxes": torch.gather(boxes, 1, idx[..., None].expand(-1, -1, width)),
                "scores": scores, "labels": labels, "valid": mask, "rois": None}
    scores = torch.sigmoid(cls).amax(dim=-1)
    labels = cls.argmax(dim=-1) + 1
    masked = torch.where(scores > float(post_cfg.SCORE_THRESH), scores, float("-inf"))
    k = min(int(nms_cfg.NMS_PRE_MAXSIZE), masked.shape[1])
    top_idx = torch.sort(masked, dim=1, descending=True, stable=True).indices[:, :k]
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, width))
    keep, keep_mask = nms_bev(top_boxes[..., :7], torch.gather(masked, 1, top_idx),
                              float(nms_cfg.NMS_THRESH), int(nms_cfg.NMS_POST_MAXSIZE))
    sel = torch.gather(top_idx, 1, keep)
    return {"boxes": torch.gather(boxes, 1, sel[..., None].expand(-1, -1, width)),
            "scores": torch.gather(scores, 1, sel), "labels": torch.gather(labels, 1, sel),
            "valid": keep_mask, "rois": None}
