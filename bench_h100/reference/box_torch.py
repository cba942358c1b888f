# Frozen copy of modest_tpu_torch/ops/box_torch.py, the benchmark's plain reference: it
# imports nothing of the port and changes only when the benchmark is redefined.
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


def enlarge_box3d(boxes3d, extra_width=(0, 0, 0)):
    ex = torch.as_tensor(extra_width, dtype=boxes3d.dtype, device=boxes3d.device)
    return torch.cat([boxes3d[..., 0:3], boxes3d[..., 3:6] + ex, boxes3d[..., 6:]], dim=-1)


def points_in_boxes_mask(points, boxes):
    """points (..., N, 3), boxes (..., M, 7) → (..., M, N) bool (z is the box
    center)."""
    shift = points[..., None, :, :3] - boxes[..., :, None, 0:3]
    c = torch.cos(-boxes[..., 6])[..., None]
    s = torch.sin(-boxes[..., 6])[..., None]
    lx = shift[..., 0] * c - shift[..., 1] * s
    ly = shift[..., 0] * s + shift[..., 1] * c
    return ((shift[..., 2].abs() <= boxes[..., :, None, 5] / 2)
            & (lx.abs() <= boxes[..., :, None, 3] / 2)
            & (ly.abs() <= boxes[..., :, None, 4] / 2))


def points_in_boxes_index(points, boxes, box_valid=None):
    """(..., N) index of the first box holding each point, -1 if none;
    ``box_valid`` (..., M) masks out padded boxes."""
    mask = points_in_boxes_mask(points, boxes)
    if box_valid is not None:
        mask = mask & box_valid[..., :, None]
    first = torch.argmax(mask.to(torch.uint8), dim=-2)  # the first maximum
    return torch.where(mask.any(dim=-2), first, -1)
