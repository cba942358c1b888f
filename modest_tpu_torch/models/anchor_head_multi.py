"""The grouped anchor head (CBGS) — port of
``modest_tpu/models/anchor_head_multi.py`` (reference pcdet
dense_heads/anchor_head_multi.py).

``RPN_HEAD_CFGS`` partitions the classes into groups; each group has its
own cls/box/dir 1x1 convs (after ``NUM_MIDDLE_CONV`` 3x3 convs per branch)
over a shared 3x3 conv, and every class has its own anchor geometry and
match thresholds (one ``ANCHOR_GENERATOR_CONFIG`` entry per class). A
multi-class ``AnchorHeadSingle`` config of ``PointPillar`` or ``SECONDNet``
also comes here, as one group without the shared conv (unless it sets
``SHARED_CONV_NUM_FILTER``), as in the JAX package.

The predictions put the class axis outside the location axis, so the anchor
order is [group][class][y][x][rot], the order ``generate_multiclass_anchors``
makes, and a group's classes fill their own columns of a (B, A, C) logit
tensor whose other columns hold −1e9. The target assignment runs as one
pass with per-anchor thresholds and classes. Module names follow pcdet's
(``shared_conv``, ``rpn_heads.<g>.conv_{cls,box,dir_cls}``); the middle
convs are ``rpn_heads.<g>.{cls,box,dir}_mid``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..utils.config import Config
from .box_coders import ResidualCoder
from .grid_detectors import _conv_bn_relu, aligned_bev_iou, generate_anchors, grid_detector_loss


def generate_multiclass_anchors(anchor_cfgs, grid_size, point_cloud_range, class_names,
                                head_groups):
    """Anchors ordered [group][class][y][x][z·size·rot]. Returns (anchors
    (A, 7), anchor_cls (A,) 1-based class ids, matched_thr (A,),
    unmatched_thr (A,), the anchor count of each group)."""
    by_name = {c["class_name"]: c for c in anchor_cfgs}
    anchors, cls_ids, m_thr, u_thr, head_counts = [], [], [], [], []
    for group in head_groups:
        count = 0
        for name in group:
            cfg = by_name[name]
            a, _ = generate_anchors([cfg], grid_size, point_cloud_range)
            anchors.append(a)
            cls_ids.append(np.full(len(a), class_names.index(name) + 1, np.int32))
            m_thr.append(np.full(len(a), cfg["matched_threshold"], np.float32))
            u_thr.append(np.full(len(a), cfg["unmatched_threshold"], np.float32))
            count += len(a)
        head_counts.append(count)
    return (np.concatenate(anchors), np.concatenate(cls_ids), np.concatenate(m_thr),
            np.concatenate(u_thr), head_counts)


@torch.no_grad()
def assign_multiclass_targets(anchors, anchor_cls, matched_thr, unmatched_thr, gt_boxes,
                              box_coder):
    """Class-aware axis-aligned target assignment over the batch (reference
    axis_aligned_target_assigner.py:8-141, its per-class loop a class mask
    on the overlaps). gt_boxes (B, M, D+1), the class id in the last column
    and D box columns (7, or 9 with velocity). Returns labels (B, A) (-1
    ignore, 0 background, class id), reg_targets (B, A, code), reg_weights
    (B, A) and the matched gt heading (B, A), 0 off the foreground."""
    gt_valid = gt_boxes.abs().sum(-1) > 0
    gt_cls = gt_boxes[..., -1].long()
    ov = aligned_bev_iou(anchors, gt_boxes[..., :7])  # (B, A, M)
    pair_ok = gt_valid[:, None, :] & (anchor_cls[None, :, None] == gt_cls[:, None, :])
    ov = torch.where(pair_ok, ov, -1.0)
    a2g_max = ov.amax(dim=2)
    a2g_arg = ov.argmax(dim=2)  # the first maximum, as jnp.argmax
    g2a_max = ov.amax(dim=1)
    g2a_max = torch.where(g2a_max <= 0, -1.0, g2a_max)
    force = (((ov == g2a_max[:, None, :]) & pair_ok & (g2a_max > 0)[:, None, :]).any(dim=2)
             & (a2g_max > 0))
    labels = torch.where(force | (a2g_max >= matched_thr), anchor_cls.long(),
                         torch.where(a2g_max < unmatched_thr, 0, -1))
    labels = torch.where(gt_valid.any(dim=1, keepdim=True), labels, 0)
    n_box = gt_boxes.shape[-1] - 1
    matched = torch.gather(gt_boxes, 1, a2g_arg[..., None].expand(-1, -1, gt_boxes.shape[-1]))
    reg_targets = box_coder.encode(matched[..., :n_box], anchors.expand(*matched.shape[:2], 7))
    fg = labels > 0
    reg_targets = torch.where(fg[..., None], reg_targets, 0.0)
    return labels, reg_targets, fg.float(), torch.where(fg, matched[..., 6], 0.0)


class SingleGroupHead(nn.Module):
    """One class group's convs (reference SingleHead, one fused box conv):
    per branch ``num_middle_conv`` 3x3 conv → BN → ReLU layers, then the
    1x1 cls, box and dir convs; NCHW in, NCHW out."""

    def __init__(self, in_channels: int, num_class: int, num_anchors_per_loc: int,
                 code_size: int, num_middle_conv: int = 0, num_middle_filter: int = 64,
                 num_dir_bins: int = 2, use_dir: bool = True):
        super().__init__()
        na = num_anchors_per_loc

        def branch(out_channels):
            layers, c_in = [], in_channels
            for _ in range(num_middle_conv):
                layers += _conv_bn_relu(c_in, num_middle_filter)
                c_in = num_middle_filter
            return nn.Sequential(*layers), nn.Conv2d(c_in, out_channels, 1)

        self.cls_mid, self.conv_cls = branch(na * num_class)
        self.box_mid, self.conv_box = branch(na * code_size)
        self.dir_mid, self.conv_dir_cls = branch(na * num_dir_bins) if use_dir else (None, None)

    def forward(self, x):
        dir_cls = self.conv_dir_cls(self.dir_mid(x)) if self.conv_dir_cls is not None else None
        return self.conv_cls(self.cls_mid(x)), self.conv_box(self.box_mid(x)), dir_cls


class AnchorHeadMulti(nn.Module):
    """The shared conv (a 3x3 conv → BN → ReLU, for a real AnchorHeadMulti
    or where ``SHARED_CONV_NUM_FILTER`` is set) and one ``SingleGroupHead``
    per class group. ``forward(bev (B, C, H, W), gt_boxes=None)`` returns
    the class-major predictions with their anchors, and with ``gt_boxes``
    the targets."""

    def __init__(self, model_cfg, class_names, grid_size, point_cloud_range, in_channels: int,
                 code_size: int = 7, encode_angle_by_sincos: bool = False):
        super().__init__()
        cfg = Config(model_cfg)
        self.class_names = tuple(class_names)
        shared = cfg.get("SHARED_CONV_NUM_FILTER", None)
        use_shared = shared is not None or cfg.get("NAME", "AnchorHeadMulti") != "AnchorHeadSingle"
        shared_ch = int(shared) if shared is not None else 64
        self.shared_conv = nn.Sequential(*_conv_bn_relu(in_channels, shared_ch)) \
            if use_shared else None
        c_in = shared_ch if use_shared else in_channels
        self.head_groups = ([tuple(h.HEAD_CLS_NAME) for h in cfg.RPN_HEAD_CFGS]
                            if cfg.get("RPN_HEAD_CFGS") else [self.class_names])
        self.box_coder = ResidualCoder(code_size, encode_angle_by_sincos)
        anchor_cfgs = [c.to_dict() for c in cfg.ANCHOR_GENERATOR_CONFIG]
        by_name = {c["class_name"]: c for c in anchor_cfgs}
        per_loc = {n: len(by_name[n]["anchor_rotations"]) * len(by_name[n]["anchor_sizes"])
                   * len(by_name[n]["anchor_bottom_heights"]) for n in self.class_names}
        anchors, acls, m_thr, u_thr, _ = generate_multiclass_anchors(
            anchor_cfgs, grid_size, point_cloud_range, list(self.class_names),
            self.head_groups)
        for name, value in (("anchors", anchors), ("anchor_cls", acls), ("matched_thr", m_thr),
                            ("unmatched_thr", u_thr)):
            self.register_buffer(name, torch.from_numpy(value), persistent=False)
        self.num_dir_bins = int(cfg.get("NUM_DIR_BINS", 2))
        heads = []
        for group in self.head_groups:
            if len({per_loc[n] for n in group}) != 1:
                raise ValueError(f"classes sharing a head must have equal anchors per location "
                                 f"(group {group})")
            heads.append(SingleGroupHead(
                c_in, len(group), sum(per_loc[n] for n in group), self.box_coder.code_size,
                num_middle_conv=int(cfg.get("NUM_MIDDLE_CONV", 0)),
                num_middle_filter=int(cfg.get("NUM_MIDDLE_FILTER", 64)),
                num_dir_bins=self.num_dir_bins,
                use_dir=bool(cfg.get("USE_DIRECTION_CLASSIFIER", True))))
        self.rpn_heads = nn.ModuleList(heads)

    def forward(self, bev, gt_boxes=None):
        x = self.shared_conv(bev) if self.shared_conv is not None else bev
        num_class = len(self.class_names)
        cls_list, box_list, dir_list = [], [], []
        for head, group in zip(self.rpn_heads, self.head_groups):
            cls, box, dir_cls = head(x)
            b, _, fy, fx = cls.shape
            ncls = len(group)

            def reorder(t, ch):
                # channels [class][rot][ch] per location → anchors [class][y][x][rot]
                t = t.permute(0, 2, 3, 1).reshape(b, fy, fx, ncls, -1, ch)
                return t.permute(0, 3, 1, 2, 4, 5).reshape(b, -1, ch)

            cls = reorder(cls, ncls)
            full = cls.new_full((*cls.shape[:2], num_class), -1e9)
            for j, name in enumerate(group):
                full[..., self.class_names.index(name)] = cls[..., j]
            cls_list.append(full)
            box_list.append(reorder(box, self.box_coder.code_size))
            dir_list.append(reorder(dir_cls, self.num_dir_bins) if dir_cls is not None else None)
        out = {"cls_preds": torch.cat(cls_list, dim=1), "box_preds": torch.cat(box_list, dim=1),
               "dir_cls_preds": torch.cat(dir_list, dim=1) if dir_list[0] is not None else None,
               "anchors": self.anchors, "anchor_cls": self.anchor_cls,
               "box_coder_sincos": self.box_coder.encode_angle_by_sincos}
        if gt_boxes is not None:
            (out["box_cls_labels"], out["box_reg_targets"], _,
             out["box_gt_heading"]) = assign_multiclass_targets(
                self.anchors, self.anchor_cls, self.matched_thr, self.unmatched_thr, gt_boxes,
                self.box_coder)
        return out


def multihead_loss(out, cfg, num_class: int):
    """The anchor losses over the class-major anchors (reference
    anchor_head_multi.py:245-345 in one pass: the groups share the math)."""
    return grid_detector_loss(out, cfg, num_class=num_class)
