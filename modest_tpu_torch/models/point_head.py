"""Stage-1 point head — port of ``modest_tpu/models/point_head.py``
(reference pcdet dense_heads/point_head_box.py), eval forward."""
from __future__ import annotations

from torch import nn

from .layers import FCHead


class PointHeadBox(nn.Module):
    def __init__(self, in_channels: int, num_class: int, cls_fc, reg_fc, code_size: int):
        super().__init__()
        self.cls_layers = FCHead(in_channels, cls_fc, num_class)
        self.box_layers = FCHead(in_channels, reg_fc, code_size)

    def forward(self, point_features):
        """(B, N, C) → (cls_preds (B, N, num_class), box_preds (B, N, code))."""
        return self.cls_layers(point_features), self.box_layers(point_features)
