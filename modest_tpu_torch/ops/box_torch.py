"""3D box geometry on tensors — port of ``modest_tpu/ops/box_jax.py``.

Box layout: (x, y, z, dx, dy, dz, heading), center z, heading CCW around +z.
"""
from __future__ import annotations

import math

import torch

_CORNER_SIGNS = (
    (1, 1, -1), (1, -1, -1), (-1, -1, -1), (-1, 1, -1),
    (1, 1, 1), (1, -1, 1), (-1, -1, 1), (-1, 1, 1),
)


def corner_template(device=None, dtype=torch.float32) -> torch.Tensor:
    """(8, 3) unit-box corners, built on ``device`` when asked for."""
    return torch.tensor(_CORNER_SIGNS, dtype=dtype, device=device) / 2


def limit_period(val, offset: float = 0.5, period: float = math.pi):
    return val - torch.floor(val / period + offset) * period


def rotate_points_along_z(points, angle):
    """points (..., N, 3+C), angle (...,) → rotated CCW around +z."""
    c = torch.cos(angle)[..., None]
    s = torch.sin(angle)[..., None]
    x, y = points[..., 0], points[..., 1]
    xr = x * c - y * s
    yr = x * s + y * c
    return torch.cat([xr[..., None], yr[..., None], points[..., 2:]], dim=-1)


def boxes_to_corners_3d(boxes3d):
    """(N, 7) → (N, 8, 3)."""
    tmpl = corner_template(boxes3d.device, boxes3d.dtype)
    corners = boxes3d[:, None, 3:6] * tmpl[None]
    corners = rotate_points_along_z(corners, boxes3d[:, 6])
    return corners + boxes3d[:, None, 0:3]
