"""CaDDN, monocular 3D detection through categorical depth distributions —
port of ``modest_tpu/models/caddn.py`` (reference pcdet
models/detectors/caddn.py, backbones_3d/ffe/depth_ffe.py,
backbones_3d/f2v/frustum_to_voxel.py; config kitti_models/CaDDN.yaml).

An image encoder gives per-pixel features and a distribution over D
LID-spaced depth bins (and a "beyond" class); their outer product is a
frustum of features (B, H', W', D, C). Every voxel centre of the grid is
lifted into the frustum (lidar → camera → image plane and depth bin) and
samples it trilinearly; the voxel grid collapses to a BEV map (its z slices'
channels side by side, a linear layer and ReLU) for the grid detectors'
``BaseBEVBackbone`` and ``AnchorHeadSingle``. Two encoders, as in JAX: with
``FFE.DDN.NAME`` DDNDeepLabV3 the reference's DeepLabV3 DDN
(``models/ddn_deeplabv3.py``) and a 1 × 1 ``channel_reduce`` (conv, batch
norm, ReLU); else a compact stride-4 encoder (``ImageEncoder``).

The frustum sample is eight gathers of whole C-channel rows of the frustum
flattened to (B·H'·W'·D, C), by one flat row index per voxel and corner
(``F.embedding``, whose backward sums the rows' gradients), weighted and
summed in JAX's corner order. The voxel centres are enumerated (y, x, z), so
the sample is already the BEV map's (B, ny, nx, nz·C) layout: channel z·C +
c, as JAX's transpose of its (x, y, z) grid gives it. The JAX package runs
all of this in XLA, not in a Pallas kernel, so it is plain PyTorch here.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..parallel.mesh import global_sum
from ..utils.config import Config
from .box_coders import ResidualCoder
from .grid_detectors import (
    AnchorHeadSingle,
    BaseBEVBackbone,
    GridDetector,
    assign_anchor_targets,
    grid_detector_loss,
    single_head_anchor_setup,
)
from .layers import BatchNorm2d
from .losses import sigmoid_focal_loss
from .part_a2 import same_padding

IMAGE_STRIDE = 4  # the encoders' feature stride (DeepLab's layer1 too)


def lid_bin_from_depth(depth, d_min: float, d_max: float, num_bins: int):
    """Depth → fractional LID bin index (CaDDN eq. 2). The root is taken in
    float64 and rounded to float32, which is the correctly rounded float32
    root: PyTorch's vectorised float32 ``sqrt`` on the CPU is not (AVX-512:
    1490 of 200000 values 1 ulp off numpy's), and the bin edges floor on it."""
    delta = 2.0 * (d_max - d_min) / (num_bins * (1 + num_bins))
    arg = 1.0 + 8.0 * torch.clamp_min(depth - d_min, 0.0) / delta
    return -0.5 + 0.5 * torch.sqrt(arg.double()).to(depth.dtype)


def depth_to_lid_target(depth, d_min: float, d_max: float, num_bins: int):
    """Integer bin target: [0, D) in range, D (the "beyond" class) for a
    depth out of [d_min, d_max], past the last bin, or no return (≤ 0)."""
    idx = torch.floor(lid_bin_from_depth(depth, d_min, d_max, num_bins))
    idx = torch.where((depth < d_min) | (depth > d_max) | (idx >= num_bins) | (depth <= 0),
                      float(num_bins), idx)
    return idx.long()


class ImageEncoder(nn.Module):
    """The compact stride-4 encoder: per ``channels`` a 3 × 3 / 2 conv at
    flax's SAME padding ((0, 1) on an even side), batch norm and ReLU, then a
    3 × 3 conv to ``num_feats`` features and ``num_depth_bins`` + 1 depth
    logits. ``forward(x (B, 3, H, W))`` → (features, logits), NCHW."""

    def __init__(self, channels=(32, 64), num_feats: int = 64, num_depth_bins: int = 80):
        super().__init__()
        convs, bns = [], []
        c_in = 3
        for c in channels:
            convs.append(nn.Conv2d(c_in, c, 3, stride=2))
            bns.append(BatchNorm2d(c, eps=1e-5, momentum=0.1))
            c_in = c
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(bns)
        self.head = nn.Conv2d(c_in, num_feats + num_depth_bins + 1, 3, padding=1)
        self.num_feats = num_feats

    def forward(self, x):
        for conv, bn in zip(self.convs, self.bns):
            pads = [*same_padding(x.shape[3], 2), *same_padding(x.shape[2], 2)]
            x = F.relu(bn(conv(F.pad(x, pads))))
        x = self.head(x)
        return x[:, :self.num_feats], x[:, self.num_feats:]


class ChannelReduce(nn.Module):
    """pcdet's BasicBlock2D: 1 × 1 conv, batch norm, ReLU."""

    def __init__(self, c_in: int, c_out: int, bias: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, 1, bias=bias)
        self.bn = BatchNorm2d(c_out, eps=1e-5, momentum=0.1)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def sample_frustum(frustum, u, v, dbin):
    """Trilinear sample of the (B, H', W', D, C) ``frustum`` at fractional
    (u, v, dbin), (B, N) each → (B, N, C); samples outside the frustum are 0."""
    b, h, w, d, c = frustum.shape
    inb = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1) & (dbin >= 0) & (dbin <= d - 1)
    u = torch.clamp(u, 0.0, w - 1 - 1e-4)
    v = torch.clamp(v, 0.0, h - 1 - 1e-4)
    dbin = torch.clamp(dbin, 0.0, d - 1 - 1e-4)
    u0, v0, d0 = torch.floor(u), torch.floor(v), torch.floor(dbin)
    tu, tv, td = u - u0, v - v0, dbin - d0
    u0 = torch.clamp_max(u0.long(), w - 2)
    v0 = torch.clamp_max(v0.long(), h - 2)
    d0 = torch.clamp_max(d0.long(), d - 2)
    table = frustum.reshape(b * h * w * d, c)
    base = torch.arange(b, device=u.device)[:, None] * (h * w * d)
    inb = inb.to(frustum.dtype)
    out = None
    for dv in (0, 1):
        for du in (0, 1):
            for dd in (0, 1):
                idx = ((v0 + dv) * w + (u0 + du)) * d + (d0 + dd) + base
                weight = ((tv if dv else 1 - tv) * (tu if du else 1 - tu)
                          * (td if dd else 1 - td)) * inb
                corner = F.embedding(idx, table) * weight[..., None]
                out = corner if out is None else out + corner
    return out


class CaDDN(nn.Module):
    """``forward(images (B, H, W, 3), lidar_to_cam (B, 4, 4), cam_to_img (B,
    3, 4), gt_boxes=None, dropout=None, on_stage=None)`` → the outputs of
    JAX's CaDDN: the head's predictions and anchors, ``depth_logits`` (B,
    H/4, W/4, D + 1) and in train mode the anchor targets (``caddn_loss``),
    in eval mode the decoded boxes (``grid_post_process``). ``dropout`` is
    the DeepLab ASPP's keep mask or generator (``ddn_deeplabv3.ASPP``);
    ``on_stage(name)`` is called after each of ``self.stages``."""

    def __init__(self, model_cfg, num_class: int, point_cloud_range, voxel_size, grid_size):
        super().__init__()
        self.model_cfg = cfg = Config(model_cfg)
        self.num_class = num_class
        self.point_cloud_range = pcr = tuple(float(v) for v in point_cloud_range)
        self.voxel_size = vs = tuple(float(v) for v in voxel_size)
        self.grid_size = gs = tuple(int(v) for v in grid_size)
        ffe = cfg.FFE
        self.d_min = float(ffe.DISC_CFG.depth_min)
        self.d_max = float(ffe.DISC_CFG.depth_max)
        self.num_bins = int(ffe.DISC_CFG.num_bins)
        ddn_cfg = ffe.get("DDN", None)
        if ddn_cfg is not None and str(ddn_cfg.get("NAME")) == "DDNDeepLabV3":
            from .ddn_deeplabv3 import DDNDeepLabV3

            self.ddn = DDNDeepLabV3(self.num_bins + 1,
                                    str(ddn_cfg.get("BACKBONE_NAME", "ResNet101")))
            cr = ffe.get("CHANNEL_REDUCE", {"out_channels": 64})
            self.channel_reduce = ChannelReduce(int(cr.get("in_channels", 256)),
                                                int(cr.get("out_channels", 64)),
                                                bool(cr.get("bias", False)))
            feats = int(cr.get("out_channels", 64))
            encoder_stages = ("ddn_backbone", "ddn_aspp", "ddn_head", "channel_reduce")
        else:
            self.ddn = None
            self.encoder = ImageEncoder(tuple(ffe.ENCODER_CHANNELS), int(ffe.NUM_FEATURES),
                                        self.num_bins)
            feats = int(ffe.NUM_FEATURES)
            encoder_stages = ("encoder",)
        self.stages = (*encoder_stages, "frustum", "lift_sample", "bev_collapse", "backbone_2d",
                       "dense_head")
        nx, ny, nz = gs
        self.bev_collapse = nn.Linear(nz * feats, int(cfg.MAP_TO_BEV.NUM_BEV_FEATURES))
        self.backbone_2d = BaseBEVBackbone(cfg.BACKBONE_2D, int(cfg.MAP_TO_BEV.NUM_BEV_FEATURES))

        head = cfg.DENSE_HEAD
        self.box_coder = ResidualCoder()
        anchors, na, matched, unmatched, anchor_cls = single_head_anchor_setup(
            [c.to_dict() for c in head.ANCHOR_GENERATOR_CONFIG], gs, pcr)
        self.register_buffer("anchors", torch.from_numpy(anchors), persistent=False)
        for key, value in (("matched_thr", matched), ("unmatched_thr", unmatched),
                           ("anchor_cls", anchor_cls)):
            if value is None or isinstance(value, float):
                setattr(self, key, value)
            else:
                self.register_buffer(key, torch.from_numpy(value), persistent=False)
        self.dense_head = AnchorHeadSingle(
            self.backbone_2d.num_bev_features, num_class, na, self.box_coder.code_size,
            num_dir_bins=int(head.get("NUM_DIR_BINS", 2)),
            use_dir=bool(head.get("USE_DIRECTION_CLASSIFIER", True)))

        # voxel centres, homogeneous, enumerated (y, x, z): the BEV map's order
        ys = (torch.arange(ny, dtype=torch.float32) + 0.5) * vs[1] + pcr[1]
        xs = (torch.arange(nx, dtype=torch.float32) + 0.5) * vs[0] + pcr[0]
        zs = (torch.arange(nz, dtype=torch.float32) + 0.5) * vs[2] + pcr[2]
        gy, gx, gz = torch.meshgrid(ys, xs, zs, indexing="ij")
        self.register_buffer("centers", torch.stack(
            [gx, gy, gz, torch.ones_like(gx)], -1).reshape(-1, 4), persistent=False)

    generate_predicted_boxes = GridDetector.generate_predicted_boxes

    def image_features(self, images, dropout=None, mark=None):
        """Images (B, H, W, 3) → (features (B, C, H', W'), depth logits (B,
        D + 1, H', W'))."""
        mark = mark or (lambda name: None)
        x = images.permute(0, 3, 1, 2)
        if self.ddn is None:
            feats, logits = self.encoder(x)
            mark("encoder")
            return feats, logits
        feats, logits = self.ddn(x, dropout=dropout, on_stage=mark)
        mark("ddn_head")
        feats = self.channel_reduce(feats)
        mark("channel_reduce")
        return feats, logits

    def frustum(self, feats, depth_logits):
        """The frustum (B, H', W', D, C): the depth distribution's D bins
        (the softmax over D + 1 classes) times the features (CaDDN eq. 1)."""
        depth_probs = torch.softmax(depth_logits, dim=1)[:, :self.num_bins]
        return depth_probs.permute(0, 2, 3, 1)[..., :, None] * feats.permute(0, 2, 3, 1)[
            ..., None, :]

    def lift(self, lidar_to_cam, cam_to_img):
        """The voxel centres' (u, v, depth bin) in the frustum, (B, N) each."""
        cam = self.centers @ lidar_to_cam.transpose(1, 2)  # (B, N, 4)
        img = cam[..., :3] @ cam_to_img[:, :, :3].transpose(1, 2) + cam_to_img[:, None, :, 3]
        depth = img[..., 2]
        uu = img[..., 0] / torch.clamp_min(depth, 1e-4) / IMAGE_STRIDE
        vv = img[..., 1] / torch.clamp_min(depth, 1e-4) / IMAGE_STRIDE
        db = lid_bin_from_depth(depth, self.d_min, self.d_max, self.num_bins)
        return uu, vv, torch.where(depth <= 0, -1.0, db)

    def bev_map(self, vox):
        """Sampled voxels (B, ny·nx·nz, C) → the BEV map (B, F, ny, nx): the z
        slices' channels side by side, ``bev_collapse`` and ReLU."""
        nx, ny, _ = self.grid_size
        bev = F.relu(self.bev_collapse(vox.view(vox.shape[0], ny, nx, -1)))
        return bev.permute(0, 3, 1, 2).contiguous()

    def head(self, bev2d, gt_boxes=None):
        """The anchor head on the BEV backbone's map: its predictions and
        anchors, and the targets (train mode) or the decoded boxes (eval)."""
        cls_preds, box_preds, dir_preds = self.dense_head(bev2d)
        out = {"cls_preds": cls_preds, "box_preds": box_preds, "dir_cls_preds": dir_preds,
               "anchors": self.anchors}
        if self.training:
            out["box_cls_labels"], out["box_reg_targets"], _ = assign_anchor_targets(
                self.anchors, gt_boxes, self.box_coder, self.matched_thr, self.unmatched_thr,
                self.anchor_cls)
        else:
            out["batch_cls_preds"], out["batch_box_preds"] = self.generate_predicted_boxes(
                cls_preds, box_preds, dir_preds)
        return out

    def forward(self, images, lidar_to_cam, cam_to_img, gt_boxes=None, dropout=None,
                on_stage=None):
        if self.training and gt_boxes is None:
            raise ValueError("CaDDN: train mode needs gt_boxes; call .eval() for the eval "
                             "forward")
        mark = on_stage or (lambda name: None)
        feats, depth_logits = self.image_features(images, dropout, mark)
        frustum = self.frustum(feats, depth_logits)
        mark("frustum")
        vox = sample_frustum(frustum, *self.lift(lidar_to_cam, cam_to_img))
        del frustum
        mark("lift_sample")
        bev = self.bev_map(vox)
        del vox
        mark("bev_collapse")
        bev2d = self.backbone_2d(bev)
        mark("backbone_2d")
        out = self.head(bev2d, gt_boxes)
        out["depth_logits"] = depth_logits.permute(0, 2, 3, 1)
        mark("dense_head")
        return out


def caddn_depth_loss(depth_logits, depth_maps, d_min: float, d_max: float, num_bins: int,
                     stride: int = IMAGE_STRIDE, gt_boxes2d=None, fg_weight: float = 13.0,
                     bg_weight: float = 1.0):
    """Focal loss of the depth distribution (B, H', W', D + 1) against the
    lidar depth maps (B, H, W), at full image resolution (subsampled by
    ``stride``) or already at the logits' (``downsample_depth_map``); 0 = no
    return, weight 0. ``gt_boxes2d`` (B, M, 4) [u1 v1 u2 v2] in image pixels,
    zero rows padding, weigh the pixels inside any box ``fg_weight``, the
    others ``bg_weight`` (reference DDNLoss)."""
    b, hf, wf, _ = depth_logits.shape
    if depth_maps.shape[1] > hf:
        dm = depth_maps[:, ::stride, ::stride][:, :hf, :wf]
    else:
        dm = depth_maps[:, :hf, :wf]
    target = depth_to_lid_target(dm, d_min, d_max, num_bins)
    w = (dm > 0).to(depth_logits.dtype)
    if gt_boxes2d is not None:
        bx = gt_boxes2d / stride
        real = gt_boxes2d.abs().sum(-1) > 0  # (B, M)
        u = torch.arange(wf, dtype=torch.float32, device=dm.device)[None, None, None, :]
        v = torch.arange(hf, dtype=torch.float32, device=dm.device)[None, None, :, None]
        inside = ((u >= bx[..., 0, None, None]) & (u < bx[..., 2, None, None])
                  & (v >= bx[..., 1, None, None]) & (v < bx[..., 3, None, None])
                  & real[..., None, None])
        w = w * torch.where(inside.any(dim=1), fg_weight, bg_weight)
    one_hot = F.one_hot(target, num_bins + 1).to(depth_logits.dtype)
    per = sigmoid_focal_loss(depth_logits, one_hot, w)
    return per.sum() / torch.clamp_min(global_sum(w.sum()), 1.0)


def caddn_loss(out, gt_boxes, cfg, num_class: int = 1, depth_maps=None):
    """The anchor head's losses and, where depth maps are given (here or
    riding in ``out``), the weighted depth loss. Returns (loss, metrics)."""
    total, metrics = grid_detector_loss(out, cfg, num_class)
    if depth_maps is None:
        depth_maps = out.get("depth_maps")
    if depth_maps is not None:
        ffe = cfg.FFE
        lw = ffe.LOSS_CONFIG.LOSS_WEIGHTS
        ld = caddn_depth_loss(
            out["depth_logits"], depth_maps, float(ffe.DISC_CFG.depth_min),
            float(ffe.DISC_CFG.depth_max), int(ffe.DISC_CFG.num_bins),
            gt_boxes2d=out.get("gt_boxes2d"), fg_weight=float(lw.get("fg_weight", 13.0)),
            bg_weight=float(lw.get("bg_weight", 1.0))) * float(lw.ddn_loss_weight)
        total = total + ld
        metrics = {**metrics, "loss": total, "depth_loss": ld}
    return total, metrics
