"""Box residual coders — port of ``modest_tpu/models/box_coders.py``
(reference pcdet/utils/box_coder_utils.py): anchor residuals (7 dims, or
9 with velocity and the heading as (cos, sin)) for the anchor heads and the
RoI heads, and mean-size anchors with a (cos, sin) heading for the point
heads."""
from __future__ import annotations

import torch


class ResidualCoder:
    """Anchor-relative residual coder: 7 box residuals, the heading as a
    plain residual or, with ``encode_angle_by_sincos``, as (cos, sin)
    differences (``code_size`` then counts one more), and any channels past
    the 7th (nuScenes' velocity) as identity residuals against an anchor
    that has none."""

    def __init__(self, code_size: int = 7, encode_angle_by_sincos: bool = False):
        self.code_size = code_size + int(encode_angle_by_sincos)
        self.encode_angle_by_sincos = encode_angle_by_sincos

    def encode(self, boxes, anchors):
        xa, ya, za, dxa, dya, dza, ra = torch.split(anchors[..., :7], 1, dim=-1)
        xg, yg, zg, dxg, dyg, dzg, rg = torch.split(boxes[..., :7], 1, dim=-1)
        dxa, dya, dza = dxa.clamp_min(1e-5), dya.clamp_min(1e-5), dza.clamp_min(1e-5)
        dxg, dyg, dzg = dxg.clamp_min(1e-5), dyg.clamp_min(1e-5), dzg.clamp_min(1e-5)
        diag = torch.sqrt(dxa**2 + dya**2)
        heading = ([torch.cos(rg) - torch.cos(ra), torch.sin(rg) - torch.sin(ra)]
                   if self.encode_angle_by_sincos else [rg - ra])
        return torch.cat([(xg - xa) / diag, (yg - ya) / diag, (zg - za) / dza,
                          torch.log(dxg / dxa), torch.log(dyg / dya), torch.log(dzg / dza),
                          *heading, boxes[..., 7:]], dim=-1)

    def decode(self, encodings, anchors):
        xa, ya, za, dxa, dya, dza, ra = torch.split(anchors[..., :7], 1, dim=-1)
        xt, yt, zt, dxt, dyt, dzt = torch.split(encodings[..., :6], 1, dim=-1)
        if self.encode_angle_by_sincos:
            cost, sint = encodings[..., 6:7], encodings[..., 7:8]
            rg = torch.atan2(sint + torch.sin(ra), cost + torch.cos(ra))
        else:
            rg = encodings[..., 6:7] + ra
        diag = torch.sqrt(dxa**2 + dya**2)
        # clip: exp overflow would turn masked-out rows into nan downstream
        return torch.cat([xt * diag + xa, yt * diag + ya, zt * dza + za,
                          torch.exp(dxt.clamp(-12.0, 12.0)) * dxa,
                          torch.exp(dyt.clamp(-12.0, 12.0)) * dya,
                          torch.exp(dzt.clamp(-12.0, 12.0)) * dza,
                          rg, encodings[..., 7 + int(self.encode_angle_by_sincos):]], dim=-1)


class PointResidualCoder:
    """Point-relative 8-dim (cos, sin) coder with per-class mean-size anchors."""

    def __init__(self, mean_size, code_size: int = 8, use_mean_size: bool = True):
        if not use_mean_size or code_size != 8:
            raise NotImplementedError("PointResidualCoder port: mean-size anchors, 8 dims only")
        self.code_size = code_size
        self.mean_size = torch.tensor(mean_size, dtype=torch.float32)

    def _anchor(self, classes, device):
        """Mean size of each 1-based class (class 0 and below read row 0)."""
        return self.mean_size.to(device)[(classes.long() - 1).clamp_min(0)]

    def encode(self, gt_boxes, points, gt_classes):
        """gt_boxes (N, 7), points (N, 3), gt_classes (N,) in 1..C → (N, 8)."""
        gt_boxes = torch.cat([gt_boxes[..., :3], gt_boxes[..., 3:6].clamp_min(1e-5),
                              gt_boxes[..., 6:7]], -1)
        xg, yg, zg, dxg, dyg, dzg, rg = torch.split(gt_boxes, 1, dim=-1)
        xa, ya, za = torch.split(points[..., :3], 1, dim=-1)
        dxa, dya, dza = torch.split(self._anchor(gt_classes, gt_boxes.device), 1, dim=-1)
        diag = torch.sqrt(dxa**2 + dya**2)
        return torch.cat([(xg - xa) / diag, (yg - ya) / diag, (zg - za) / dza,
                          torch.log(dxg / dxa), torch.log(dyg / dya), torch.log(dzg / dza),
                          torch.cos(rg), torch.sin(rg)], dim=-1)

    def decode(self, encodings, points, pred_classes):
        xt, yt, zt, dxt, dyt, dzt, cost, sint = torch.split(encodings[..., :8], 1, dim=-1)
        xa, ya, za = torch.split(points[..., :3], 1, dim=-1)
        dxa, dya, dza = torch.split(self._anchor(pred_classes, encodings.device), 1, dim=-1)
        diag = torch.sqrt(dxa**2 + dya**2)
        return torch.cat([xt * diag + xa, yt * diag + ya, zt * dza + za,
                          torch.exp(dxt.clamp(-12.0, 12.0)) * dxa,
                          torch.exp(dyt.clamp(-12.0, 12.0)) * dya,
                          torch.exp(dzt.clamp(-12.0, 12.0)) * dza,
                          torch.atan2(sint, cost)], dim=-1)
