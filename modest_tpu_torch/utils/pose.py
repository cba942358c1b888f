"""SE(3) pose algebra for multi-traversal alignment.

The port's own copy of ``modest_tpu/utils/pose.py`` (numpy only): the
KITTI↔nuScenes yaw fixups, the oxts pose files and the relative pose chain
of the reference's ``generate_cluster_mask/pre_compute_pp_score.py:22-28``.
"""
from __future__ import annotations

import numpy as np


def euler_xyz_to_matrix(angles) -> np.ndarray:
    """Extrinsic x-y-z Euler angles → 3x3 rotation (scipy 'xyz' convention:
    R = Rz(c) @ Ry(b) @ Rx(a) for angles (a, b, c))."""
    a, b, c = angles
    ca, sa = np.cos(a), np.sin(a)
    cb, sb = np.cos(b), np.sin(b)
    cc, sc = np.cos(c), np.sin(c)
    Rx = np.array([[1, 0, 0], [0, ca, -sa], [0, sa, ca]])
    Ry = np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]])
    Rz = np.array([[cc, -sc, 0], [sc, cc, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def matrix_to_euler_xyz(R: np.ndarray) -> np.ndarray:
    """Inverse of :func:`euler_xyz_to_matrix` (extrinsic xyz)."""
    sy = np.sqrt(R[0, 0] ** 2 + R[1, 0] ** 2)
    if sy > 1e-8:
        a = np.arctan2(R[2, 1], R[2, 2])
        b = np.arctan2(-R[2, 0], sy)
        c = np.arctan2(R[1, 0], R[0, 0])
    else:  # gimbal lock
        a = np.arctan2(-R[1, 2], R[1, 1])
        b = np.arctan2(-R[2, 0], sy)
        c = 0.0
    return np.array([a, b, c])


def pose_from_oxts_line(vals) -> np.ndarray:
    """oxts/*.txt line = [x y z rx ry rz] → 4x4 ego pose (float32)."""
    vals = np.asarray(vals, dtype=np.float64)
    T = np.eye(4)
    T[:3, 3] = vals[:3]
    T[:3, :3] = euler_xyz_to_matrix(vals[3:6])
    return T.astype(np.float32)


def load_oxts_pose(path) -> np.ndarray:
    with open(path) as f:
        vals = [float(x) for x in f.readline().split()]
    return pose_from_oxts_line(vals)


def rotz4(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    T = np.eye(4)
    T[0, 0] = c
    T[0, 1] = -s
    T[1, 0] = s
    T[1, 1] = c
    return T


# KITTI→nuScenes frame fixups (yaw-only rotations):
KITTI2NU_LYFT = rotz4(np.pi)
KITTI2NU_NUSC = rotz4(np.pi / 2)


def get_relative_pose(fixed_l2e, fixed_ego, query_l2e, query_ego, kitti2nu=KITTI2NU_LYFT) -> np.ndarray:
    """Transform that maps points from the query frame's KITTI-lidar coords
    into the fixed frame's KITTI-lidar coords:
    KITTI2NU^-1 · fixed_l2e^-1 · fixed_ego^-1 · query_ego · query_l2e · KITTI2NU."""
    rhs = query_ego @ query_l2e @ kitti2nu
    out = np.linalg.solve(kitti2nu, np.linalg.solve(fixed_l2e, np.linalg.solve(fixed_ego, rhs)))
    return out.astype(np.float32)


def transform_points(points: np.ndarray, T: np.ndarray) -> np.ndarray:
    """(N,3) points through a 4x4 transform."""
    return points @ T[:3, :3].T + T[:3, 3]
