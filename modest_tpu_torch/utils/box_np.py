"""Host-side (numpy) 3D box geometry — the port's own copy of
``modest_tpu/utils/box_np.py``.

Box convention (lidar): (x, y, z, dx, dy, dz, heading) with (x, y, z) the box
CENTER and heading CCW around +z — identical to the reference's pcdet format
(box_utils.py:28-53). Camera boxes: (x, y, z, l, h, w, ry) with (x, y, z) the
BOTTOM center and ry around +y (KITTI label format).
"""
from __future__ import annotations

import numpy as np

CORNER_TEMPLATE = (
    np.array(
        [
            [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
            [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1],
        ],
        dtype=np.float32,
    )
    / 2
)


def limit_period(val, offset=0.5, period=np.pi):
    return val - np.floor(val / period + offset) * period


def rotate_points_along_z(points: np.ndarray, angle: np.ndarray) -> np.ndarray:
    """(B, N, 3+C) points rotated CCW by (B,) angles around +z."""
    c, s = np.cos(angle), np.sin(angle)
    ones = np.ones_like(c)
    zeros = np.zeros_like(c)
    rot = np.stack(
        [c, s, zeros, -s, c, zeros, zeros, zeros, ones], axis=1
    ).reshape(-1, 3, 3)
    xyz = points[:, :, 0:3] @ rot
    return np.concatenate([xyz, points[:, :, 3:]], axis=-1)


def boxes_to_corners_3d(boxes3d: np.ndarray) -> np.ndarray:
    """(N, 7) lidar boxes → (N, 8, 3) corners (reference box_utils.py:28-53)."""
    boxes3d = np.asarray(boxes3d)
    corners = boxes3d[:, None, 3:6] * CORNER_TEMPLATE[None]
    corners = rotate_points_along_z(corners, boxes3d[:, 6])
    return corners + boxes3d[:, None, 0:3]


def enlarge_box3d(boxes3d: np.ndarray, extra_width=(0, 0, 0)) -> np.ndarray:
    out = np.array(boxes3d, copy=True)
    out[:, 3:6] += np.asarray(extra_width)[None, :]
    return out


def mask_boxes_outside_range(boxes: np.ndarray, limit_range, min_num_corners=1) -> np.ndarray:
    """Keep boxes with ≥ min_num_corners corners inside limit_range."""
    corners = boxes_to_corners_3d(boxes[:, 0:7])
    lo = np.asarray(limit_range[0:3])
    hi = np.asarray(limit_range[3:6])
    inside = ((corners >= lo) & (corners <= hi)).all(axis=2)
    return inside.sum(axis=1) >= min_num_corners


def mask_points_by_range(points: np.ndarray, limit_range) -> np.ndarray:
    return (
        (points[:, 0] >= limit_range[0])
        & (points[:, 0] <= limit_range[3])
        & (points[:, 1] >= limit_range[1])
        & (points[:, 1] <= limit_range[4])
    )


def points_in_boxes_mask(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """(M boxes, N points) bool mask of points inside rotated lidar boxes.

    Replaces the reference's roiaware_pool3d points_in_boxes_cpu.
    """
    if len(boxes) == 0:
        return np.zeros((0, points.shape[0]), dtype=bool)
    shift = points[None, :, 0:3] - boxes[:, None, 0:3]  # (M, N, 3)
    c, s = np.cos(-boxes[:, 6]), np.sin(-boxes[:, 6])
    local_x = shift[:, :, 0] * c[:, None] - shift[:, :, 1] * s[:, None]
    local_y = shift[:, :, 0] * s[:, None] + shift[:, :, 1] * c[:, None]
    return (
        (np.abs(shift[:, :, 2]) <= boxes[:, None, 5] / 2)
        & (np.abs(local_x) <= boxes[:, None, 3] / 2)
        & (np.abs(local_y) <= boxes[:, None, 4] / 2)
    )


def points_in_box_index(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """(N,) index of the first box containing each point, -1 if none.

    Matches the reference's points_in_boxes_gpu assignment semantics.
    """
    mask = points_in_boxes_mask(points, boxes)  # (M, N)
    if mask.shape[0] == 0:
        return np.full(points.shape[0], -1, dtype=np.int64)
    any_hit = mask.any(axis=0)
    first = mask.argmax(axis=0)
    return np.where(any_hit, first, -1)


# ---------------------------------------------------------------------------
# lidar ↔ camera conversions (reference: box_utils.py:92-238)
# ---------------------------------------------------------------------------


def boxes3d_kitti_camera_to_lidar(boxes3d_camera: np.ndarray, calib) -> np.ndarray:
    """(N,7) camera [x,y,z,l,h,w,r] (bottom center) → lidar center boxes."""
    boxes = np.array(boxes3d_camera, copy=True)
    xyz_camera, r = boxes[:, 0:3], boxes[:, 6:7]
    l, h, w = boxes[:, 3:4], boxes[:, 4:5], boxes[:, 5:6]
    xyz_lidar = calib.rect_to_lidar(xyz_camera)
    xyz_lidar[:, 2] += h[:, 0] / 2
    return np.concatenate([xyz_lidar, l, w, h, -(r + np.pi / 2)], axis=-1)


def boxes3d_lidar_to_kitti_camera(boxes3d_lidar: np.ndarray, calib) -> np.ndarray:
    """(N,7) lidar center boxes → camera [x,y,z,l,h,w,r] (bottom center)."""
    boxes = np.array(boxes3d_lidar, copy=True)
    xyz_lidar = boxes[:, 0:3]
    l, w, h = boxes[:, 3:4], boxes[:, 4:5], boxes[:, 5:6]
    r = boxes[:, 6:7]
    xyz_lidar[:, 2] -= h[:, 0] / 2
    xyz_cam = calib.lidar_to_rect(xyz_lidar)
    r = -r - np.pi / 2
    return np.concatenate([xyz_cam, l, h, w, r], axis=-1)


def boxes3d_to_corners3d_kitti_camera(boxes3d: np.ndarray, bottom_center=True) -> np.ndarray:
    """(N,7) camera boxes → (N,8,3) corners (reference box_utils.py:195-238)."""
    n = boxes3d.shape[0]
    l, h, w = boxes3d[:, 3], boxes3d[:, 4], boxes3d[:, 5]
    x_c = np.stack([l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2], axis=1)
    z_c = np.stack([w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2], axis=1)
    if bottom_center:
        y_c = np.zeros((n, 8))
        y_c[:, 4:8] = -h[:, None]
    else:
        y_c = np.stack([h / 2] * 4 + [-h / 2] * 4, axis=1)
    ry = boxes3d[:, 6]
    zeros, ones = np.zeros(n), np.ones(n)
    # y-axis rotation applied as corners @ R (reference multiplies on the right)
    R = np.stack(
        [
            np.stack([np.cos(ry), zeros, -np.sin(ry)], axis=1),
            np.stack([zeros, ones, zeros], axis=1),
            np.stack([np.sin(ry), zeros, np.cos(ry)], axis=1),
        ],
        axis=1,
    )  # (N, 3, 3)
    corners = np.stack([x_c, y_c, z_c], axis=2) @ R
    return (corners + boxes3d[:, None, 0:3]).astype(np.float32)


def boxes3d_kitti_camera_to_imageboxes(boxes3d: np.ndarray, calib, image_shape=None) -> np.ndarray:
    """(N,7) camera boxes → (N,4) [x1,y1,x2,y2] 2D image boxes."""
    corners3d = boxes3d_to_corners3d_kitti_camera(boxes3d)
    pts_img, _ = calib.rect_to_img(corners3d.reshape(-1, 3))
    corners_img = pts_img.reshape(-1, 8, 2)
    boxes2d = np.concatenate([corners_img.min(axis=1), corners_img.max(axis=1)], axis=1)
    if image_shape is not None:
        boxes2d[:, 0] = np.clip(boxes2d[:, 0], 0, image_shape[1] - 1)
        boxes2d[:, 1] = np.clip(boxes2d[:, 1], 0, image_shape[0] - 1)
        boxes2d[:, 2] = np.clip(boxes2d[:, 2], 0, image_shape[1] - 1)
        boxes2d[:, 3] = np.clip(boxes2d[:, 3], 0, image_shape[0] - 1)
    return boxes2d
