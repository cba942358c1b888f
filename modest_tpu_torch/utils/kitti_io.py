"""KITTI on-disk data contract: calibration, labels, point clouds, planes.

The port's own copy of ``modest_tpu/utils/kitti_io.py`` (numpy only): the
seed path reads the scans and ``Calibration``, the detector's data path the
labels, planes, FOV flags and box corners.

Coordinate frames:
  velodyne/lidar: x front, y left, z up
  rect camera:    x right, y down, z front
  image2:         u right, v down
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# point cloud / plane IO
# ---------------------------------------------------------------------------


def load_velo_scan(path) -> np.ndarray:
    """Load a KITTI velodyne .bin → (N, 4) float32 [x y z intensity]."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def save_velo_scan(path, points: np.ndarray):
    np.asarray(points, dtype=np.float32).reshape(-1, 4).tofile(path)


def load_plane(path) -> np.ndarray:
    """Load a KITTI planes/*.txt ground plane (4,) in rect coords, normal up.

    Reference: pointcloud_utils.load_plane / kitti_dataset.get_road_plane.
    """
    with open(path) as f:
        lines = f.readlines()
    plane = np.asarray([float(i) for i in lines[3].split()])
    if plane[1] > 0:  # normal must face up (-y in rect coords)
        plane = -plane
    return plane / np.linalg.norm(plane[0:3])


def save_plane(path, plane: np.ndarray):
    with open(path, "w") as f:
        f.write("# Plane\nWidth 4\nHeight 1\n")
        f.write(" ".join(f"{v:.6e}" for v in np.asarray(plane).reshape(4)))
        f.write("\n")


# ---------------------------------------------------------------------------
# labels
# ---------------------------------------------------------------------------

_CLS_TO_ID = {"Car": 1, "Pedestrian": 2, "Cyclist": 3, "Van": 4, "Dynamic": 1}


def cls_type_to_id(cls_type: str) -> int:
    return _CLS_TO_ID.get(cls_type, -1)


class Object3d:
    """One KITTI label line. Mirrors kitti_util.Object3d / object3d_kitti."""

    def __init__(self, line: str):
        label = line.strip().split(" ")
        self.src = line
        self.cls_type = self.type = label[0]
        self.cls_id = cls_type_to_id(self.cls_type)
        self.truncation = float(label[1])
        self.occlusion = float(label[2])  # 0..3 (3 = unknown)
        self.alpha = float(label[3])
        self.box2d = np.array([float(x) for x in label[4:8]], dtype=np.float32)
        self.h, self.w, self.l = (float(label[8]), float(label[9]), float(label[10]))
        self.t = self.loc = np.array(
            [float(label[11]), float(label[12]), float(label[13])], dtype=np.float32
        )
        self.dis_to_cam = float(np.linalg.norm(self.t))
        self.ry = float(label[14])
        if len(label) >= 16:
            try:
                self.score = float(label[15])
            except ValueError:
                self.score = -1.0
        else:
            self.score = -1.0
        self.level = self.get_kitti_obj_level()

    def get_kitti_obj_level(self) -> int:
        height = float(self.box2d[3]) - float(self.box2d[1]) + 1
        if height >= 40 and self.truncation <= 0.15 and self.occlusion <= 0:
            return 1  # Easy
        if height >= 25 and self.truncation <= 0.3 and self.occlusion <= 1:
            return 2  # Moderate
        if height >= 25 and self.truncation <= 0.5 and self.occlusion <= 2:
            return 3  # Hard
        return 4

    def generate_corners3d(self) -> np.ndarray:
        """(8, 3) corners in rect camera coords; t is the bottom center."""
        l, h, w = self.l, self.h, self.w
        x = np.array([l, l, -l, -l, l, l, -l, -l]) / 2
        y = np.array([0, 0, 0, 0, -h, -h, -h, -h], dtype=np.float64)
        z = np.array([w, -w, -w, w, w, -w, -w, w]) / 2
        R = roty(self.ry)
        corners = R @ np.vstack([x, y, z])
        return corners.T + self.t

    def to_kitti_format(self) -> str:
        return (
            f"{self.cls_type} {self.truncation:.2f} {int(self.occlusion)} {self.alpha:.2f} "
            f"{self.box2d[0]:.2f} {self.box2d[1]:.2f} {self.box2d[2]:.2f} {self.box2d[3]:.2f} "
            f"{self.h:.2f} {self.w:.2f} {self.l:.2f} "
            f"{self.t[0]:.2f} {self.t[1]:.2f} {self.t[2]:.2f} {self.ry:.2f} {self.score:.2f}"
        )


def read_label(path) -> list:
    with open(path) as f:
        lines = [ln for ln in (l.rstrip() for l in f) if ln]
    return [Object3d(ln) for ln in lines]


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------


def inverse_rigid_trans(Tr: np.ndarray) -> np.ndarray:
    """Invert a 3x4 rigid transform [R|t] → [R'| -R't]."""
    inv = np.zeros_like(Tr)
    inv[0:3, 0:3] = Tr[0:3, 0:3].T
    inv[0:3, 3] = -Tr[0:3, 0:3].T @ Tr[0:3, 3]
    return inv


def _cart2hom(pts: np.ndarray) -> np.ndarray:
    return np.hstack((pts, np.ones((pts.shape[0], 1), dtype=pts.dtype)))


class Calibration:
    """KITTI calib file: P2/P3 projections, R0_rect, Tr_velo_to_cam.

    Mirrors kitti_util.Calibration + pcdet calibration_kitti.Calibration
    (both APIs provided: project_velo_to_rect == lidar_to_rect, etc.).
    """

    def __init__(self, calib_file):
        if isinstance(calib_file, dict):
            calibs = calib_file
        else:
            calibs = self.read_calib_file(calib_file)
        self.P = self.P2 = np.reshape(calibs["P2"], [3, 4]).astype(np.float64)
        self.P3 = np.reshape(calibs.get("P3", calibs["P2"]), [3, 4]).astype(np.float64)
        self.V2C = np.reshape(calibs["Tr_velo_to_cam"], [3, 4]).astype(np.float64)
        self.C2V = inverse_rigid_trans(self.V2C)
        self.R0 = np.reshape(calibs["R0_rect"], [3, 3]).astype(np.float64)

        self.c_u = self.P[0, 2]
        self.c_v = self.P[1, 2]
        self.f_u = self.P[0, 0]
        self.f_v = self.P[1, 1]
        self.b_x = self.P[0, 3] / (-self.f_u)
        self.b_y = self.P[1, 3] / (-self.f_v)

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

    # --- 3d ↔ 3d -----------------------------------------------------------
    def lidar_to_rect(self, pts_lidar: np.ndarray) -> np.ndarray:
        """(N,3) velodyne → rect camera coords."""
        pts_ref = _cart2hom(pts_lidar) @ self.V2C.T
        return pts_ref @ self.R0.T

    project_velo_to_rect = lidar_to_rect

    def rect_to_lidar(self, pts_rect: np.ndarray) -> np.ndarray:
        pts_ref = pts_rect @ np.linalg.inv(self.R0).T
        return _cart2hom(pts_ref) @ self.C2V.T

    project_rect_to_velo = rect_to_lidar

    # --- 3d → 2d -----------------------------------------------------------
    def rect_to_img(self, pts_rect: np.ndarray):
        """(N,3) rect → ((N,2) image uv, (N,) rect depth)."""
        pts_2d = _cart2hom(pts_rect) @ self.P.T
        uv = pts_2d[:, 0:2] / pts_2d[:, 2:3]
        depth = pts_2d[:, 2] - self.P.T[3, 2]
        return uv, depth

    def project_rect_to_image(self, pts_rect: np.ndarray) -> np.ndarray:
        return self.rect_to_img(pts_rect)[0]

    def lidar_to_img(self, pts_lidar: np.ndarray):
        return self.rect_to_img(self.lidar_to_rect(pts_lidar))

    def project_velo_to_image(self, pts_lidar: np.ndarray) -> np.ndarray:
        return self.lidar_to_img(pts_lidar)[0]

    # --- 2d → 3d -----------------------------------------------------------
    def img_to_rect(self, u, v, depth_rect):
        x = ((u - self.c_u) * depth_rect) / self.f_u + self.b_x
        y = ((v - self.c_v) * depth_rect) / self.f_v + self.b_y
        return np.stack([x, y, depth_rect], axis=-1)

    def project_image_to_rect(self, uv_depth: np.ndarray) -> np.ndarray:
        return self.img_to_rect(uv_depth[:, 0], uv_depth[:, 1], uv_depth[:, 2])


def get_fov_flag(pts_rect: np.ndarray, img_shape, calib: Calibration) -> np.ndarray:
    """Mask of rect-coord points that project inside the image and are in
    front of the camera (reference: kitti_dataset.get_fov_flag:157-174)."""
    pts_img, pts_depth = calib.rect_to_img(pts_rect)
    flag = (
        (pts_img[:, 0] >= 0)
        & (pts_img[:, 0] < img_shape[1])
        & (pts_img[:, 1] >= 0)
        & (pts_img[:, 1] < img_shape[0])
        & (pts_depth >= 0)
    )
    return flag


# ---------------------------------------------------------------------------
# rotation helpers
# ---------------------------------------------------------------------------


def rotx(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def roty(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def rotz(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def compute_box_3d(obj, P: np.ndarray):
    """Project an Object3d-like (h/w/l, t, ry) into the image.

    Returns (corners_2d (8,2), corners_3d (8,3) in rect coords).
    Reference: kitti_util.compute_box_3d:453-488.
    """
    R = roty(obj.ry)
    l, w, h = obj.l, obj.w, obj.h
    x = np.array([l, l, -l, -l, l, l, -l, -l]) / 2
    y = np.array([0, 0, 0, 0, -h, -h, -h, -h], dtype=np.float64)
    z = np.array([w, -w, -w, w, w, -w, -w, w]) / 2
    corners_3d = (R @ np.vstack([x, y, z])).T + np.asarray(obj.t).reshape(1, 3)
    pts_2d = _cart2hom(corners_3d) @ P.T
    corners_2d = pts_2d[:, 0:2] / pts_2d[:, 2:3]
    return corners_2d, corners_3d
