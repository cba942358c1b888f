"""The parts of the KITTI on-disk contract that the seed path reads.

The port's own copy of ``modest_tpu/utils/kitti_io.py``'s ``load_velo_scan``,
``save_velo_scan`` and ``Calibration`` (numpy only). Frames: velodyne x
front, y left, z up; rect camera x right, y down, z front.
"""
from __future__ import annotations

import numpy as np


def load_velo_scan(path) -> np.ndarray:
    """Load a KITTI velodyne .bin → (N, 4) float32 [x y z intensity]."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def save_velo_scan(path, points: np.ndarray):
    np.asarray(points, dtype=np.float32).reshape(-1, 4).tofile(path)


def inverse_rigid_trans(Tr: np.ndarray) -> np.ndarray:
    """Invert a 3x4 rigid transform [R|t] → [R'| -R't]."""
    inv = np.zeros_like(Tr)
    inv[0:3, 0:3] = Tr[0:3, 0:3].T
    inv[0:3, 3] = -Tr[0:3, 0:3].T @ Tr[0:3, 3]
    return inv


def _cart2hom(pts: np.ndarray) -> np.ndarray:
    return np.hstack((pts, np.ones((pts.shape[0], 1), dtype=pts.dtype)))


class Calibration:
    """KITTI calib file (P2, P3, R0_rect, Tr_velo_to_cam) or the same keys
    as a dict."""

    def __init__(self, calib_file):
        calibs = calib_file if isinstance(calib_file, dict) else self.read_calib_file(calib_file)
        self.P = self.P2 = np.reshape(calibs["P2"], [3, 4]).astype(np.float64)
        self.P3 = np.reshape(calibs.get("P3", calibs["P2"]), [3, 4]).astype(np.float64)
        self.V2C = np.reshape(calibs["Tr_velo_to_cam"], [3, 4]).astype(np.float64)
        self.C2V = inverse_rigid_trans(self.V2C)
        self.R0 = np.reshape(calibs["R0_rect"], [3, 3]).astype(np.float64)

    @staticmethod
    def read_calib_file(path) -> dict:
        data = {}
        with open(path) as f:
            for line in f:
                line = line.rstrip()
                if not line:
                    continue
                key, value = line.split(":", 1)
                try:
                    data[key] = np.array([float(x) for x in value.split()])
                except ValueError:
                    pass
        return data

    def lidar_to_rect(self, pts_lidar: np.ndarray) -> np.ndarray:
        """(N,3) velodyne → rect camera coords."""
        pts_ref = _cart2hom(pts_lidar) @ self.V2C.T
        return pts_ref @ self.R0.T

    project_velo_to_rect = lidar_to_rect
