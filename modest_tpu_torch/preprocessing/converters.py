"""Lyft / nuScenes → KITTI-format converters (pipeline stage P1/P2) — the
port's own copy of ``modest_tpu/preprocessing/converters.py`` (numpy only).

Reference: data_preprocessing/lyft/lyft2kitti.py and
data_preprocessing/nuscenes/nusc2kitti_boston.py. The SDK-independent math
(quaternion algebra, nu→KITTI box conversion, 2D projection with truncation
and depth-ordered occlusion estimation, KITTI label serialization) lives
here as pure functions; the converter classes use the lyft/nuscenes devkit
when it imports, else the SDK-free ``nu_tables.NuTables``. PIL is loaded
only where a camera frame is converted to PNG (``export_png``), which a
frame whose ``image_2`` PNG already exists skips.

Extra MODEST outputs beyond plain KITTI: per-frame ego pose ``oxts/*.txt``
(xyz + xyz-Euler) and LiDAR→ego ``l2e/*.npy`` 4x4 — the multi-traversal
alignment contract consumed by pre_compute_pp_score.
"""
from __future__ import annotations

import importlib
import os
from pathlib import Path

import numpy as np

from ..utils.pose import matrix_to_euler_xyz

LYFT_CLASS_MAP = {
    "other_vehicle": "Dynamic", "truck": "Dynamic", "car": "Dynamic",
    "bus": "Dynamic", "emergency_vehicle": "Dynamic", "pedestrian": "Dynamic",
    "motorcycle": "Dynamic", "bicycle": "Dynamic",
}

NUSC_CLASS_MAP = {
    "vehicle.car": "Dynamic", "vehicle.truck": "Dynamic", "vehicle.bus.rigid": "Dynamic",
    "vehicle.bus.bendy": "Dynamic", "vehicle.construction": "Dynamic",
    "vehicle.emergency.ambulance": "Dynamic", "vehicle.emergency.police": "Dynamic",
    "vehicle.motorcycle": "Dynamic", "vehicle.bicycle": "Dynamic",
    "human.pedestrian.adult": "Dynamic", "human.pedestrian.child": "Dynamic",
    "human.pedestrian.construction_worker": "Dynamic",
    "human.pedestrian.police_officer": "Dynamic", "vehicle.trailer": "Dynamic",
}


def quat_to_matrix(q) -> np.ndarray:
    """(w, x, y, z) quaternion → 3x3 rotation."""
    w, x, y, z = np.asarray(q, np.float64)
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n < 1e-12 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array(
        [
            [1 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1 - (xx + yy)],
        ]
    )


def form_trans_mat(translation, rotation_quat) -> np.ndarray:
    mat = np.eye(4, dtype=np.float32)
    mat[:3, :3] = quat_to_matrix(rotation_quat)
    mat[:3, 3] = translation
    return mat


def transform_matrix(translation, rotation_quat, inverse=False) -> np.ndarray:
    T = np.eye(4)
    R = quat_to_matrix(rotation_quat)
    t = np.asarray(translation, np.float64)
    if inverse:
        T[:3, :3] = R.T
        T[:3, 3] = -R.T @ t
    else:
        T[:3, :3] = R
        T[:3, 3] = t
    return T


def oxts_line_from_pose(translation, rotation_quat) -> str:
    """ego pose → 'x y z rx ry rz' (reference lyft2kitti.py:258-266)."""
    euler = matrix_to_euler_xyz(quat_to_matrix(rotation_quat))
    vals = list(np.asarray(translation, np.float64)) + list(euler)
    return " ".join(str(x) for x in vals)


def box_nu_lidar_to_kitti_camera(center, wlh, rot_matrix, velo_to_cam_kitti,
                                 kitti_to_nu_yaw=np.pi):
    """nu-lidar-frame box → KITTI camera box (x, y, z bottom-center, l, h, w, ry).

    Equivalent of KittiDB.box_nuscenes_to_kitti + the rot_y extraction in
    lyft2kitti.box_to_string:35-37: transform the box center/orientation by
    (velo_to_cam_kitti ∘ nu_to_kitti_lidar), shift center to the bottom.
    """
    nu_to_kitti = np.eye(4)
    c, s = np.cos(-kitti_to_nu_yaw), np.sin(-kitti_to_nu_yaw)
    nu_to_kitti[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    T = velo_to_cam_kitti @ nu_to_kitti
    center_cam = T[:3, :3] @ np.asarray(center) + T[:3, 3]
    rot_cam = T[:3, :3] @ np.asarray(rot_matrix)
    w, l, h = wlh
    center_cam[1] += h / 2  # true center → bottom center (camera y down)
    v = rot_cam @ np.array([1.0, 0, 0])
    rot_y = -np.arctan2(v[2], v[0])
    return np.array([center_cam[0], center_cam[1], center_cam[2], l, h, w, rot_y])


def camera_box_corners(box7) -> np.ndarray:
    from ..utils.box_np import boxes3d_to_corners3d_kitti_camera

    return boxes3d_to_corners3d_kitti_camera(np.asarray(box7, np.float64)[None])[0]


def project_box_to_2d(box7, P, height, width):
    """2D bbox + truncation/validity (reference project_to_2d:76-117)."""
    corners = camera_box_corners(box7)  # (8, 3)
    pts = corners @ P[:3, :3].T + P[:3, 3]
    uv = pts[:, :2] / np.maximum(pts[:, 2:3], 1e-9)
    bbox = (uv[:, 0].min(), uv[:, 1].min(), uv[:, 0].max(), uv[:, 1].max())
    inside = (0 <= bbox[1] < height and 0 < bbox[3] <= height) and (
        0 <= bbox[0] < width and 0 < bbox[2] <= width
    )
    valid = (
        (0 <= bbox[1] < height or 0 < bbox[3] <= height)
        and (0 <= bbox[0] < width or 0 < bbox[2] <= width)
        and (corners[:, 2] > 0).any()
    )
    truncated = valid and not inside
    if truncated:
        clipped = [
            max(0, bbox[0]), max(0, bbox[1]), min(width, bbox[2]), min(height, bbox[3])
        ]
        truncated = 1.0 - ((clipped[2] - clipped[0]) * (clipped[3] - clipped[1])) / (
            (bbox[2] - bbox[0]) * (bbox[3] - bbox[1])
        )
        bbox = tuple(clipped)
    else:
        truncated = 0.0
    return {"bbox": bbox, "truncated": float(truncated), "valid": bool(valid)}


def estimate_occlusions(objs, height, width):
    """Depth-ordered 2D-overlap occlusion levels (reference postprocessing)."""
    _map = np.full((height, width), -1, np.int32)
    objs = sorted(objs, key=lambda x: x["depth"], reverse=True)
    for i, obj in enumerate(objs):
        b = obj["bbox_2d"]
        _map[int(round(b[1])): int(round(b[3])), int(round(b[0])): int(round(b[2]))] = i
    unique, counts = np.unique(_map, return_counts=True)
    counts = dict(zip(unique.tolist(), counts.tolist()))
    for i, obj in enumerate(objs):
        visible = counts.get(i, 0)
        b = obj["bbox_2d"]
        area = max((b[3] - b[1]) * (b[2] - b[0]), 1e-9)
        occlusion = 1.0 - visible / area
        obj["occluded"] = int(np.clip(occlusion * 4, 0, 3))
    return objs


def kitti_label_line(name, box7, bbox_2d, truncation, occlusion, alpha) -> str:
    """Serialize one label (reference box_to_string:35-55 field layout)."""
    x, y, z, l, h, w, ry = box7
    return (
        f"{name} {truncation:.2f} {int(occlusion):d} {alpha:.2f} "
        f"{bbox_2d[0]:.2f} {bbox_2d[1]:.2f} {bbox_2d[2]:.2f} {bbox_2d[3]:.2f} "
        f"{h:.2f} {w:.2f} {l:.2f} {x:.2f} {y:.2f} {z:.2f} {ry:.2f}"
    )


def export_png(src, dst):
    """Write the camera frame ``src`` as the PNG ``dst`` with PIL, unless
    ``dst`` exists."""
    if not Path(dst).exists():
        importlib.import_module("PIL.Image").open(src).save(dst, "PNG")


def write_kitti_calib(path, P2, velo_to_cam_kitti, imu_to_velo=None):
    transforms = {
        "P0": np.zeros((3, 4)),
        "P1": np.zeros((3, 4)),
        "P2": np.asarray(P2).reshape(3, 4),
        "P3": np.zeros((3, 4)),
        "R0_rect": np.eye(3),
        "Tr_velo_to_cam": np.asarray(velo_to_cam_kitti)[:3].reshape(3, 4),
        "Tr_imu_to_velo": np.zeros((3, 4)) if imu_to_velo is None else imu_to_velo[:3],
    }
    with open(path, "w") as f:
        for key, val in transforms.items():
            f.write(key + ": " + " ".join("%.12e" % v for v in val.flatten()) + "\n")


class LyftToKittiConverter:
    """Drives the full Lyft → KITTI export.

    Uses lyft_dataset_sdk when installed; otherwise falls back to the
    SDK-free table reader (`nu_tables.NuTables`) — the Lyft release is
    nuScenes-schema JSON, so both paths read the same files.
    """

    def __init__(self, store_dir, lyft_dataroot, table_folder,
                 lidar_name="LIDAR_TOP", idx_offset=0, sample_token_list=None,
                 use_sdk="auto"):
        if use_sdk == "auto":
            try:
                from lyft_dataset_sdk.lyftdataset import LyftDataset  # noqa: F401
                use_sdk = True
            except ImportError:
                use_sdk = False
        self.store_dir = Path(store_dir) / "training"
        self.idx_offset = idx_offset
        if use_sdk:
            from lyft_dataset_sdk.lyftdataset import LyftDataset

            self.lyft_ds = LyftDataset(lyft_dataroot, table_folder)
        else:
            from .nu_tables import NuTables

            self.lyft_ds = NuTables(lyft_dataroot, table_folder)
        self.lidar_name = lidar_name
        self.sample_token_list = sample_token_list
        for sub in ["label_2", "label_2_full_range", "calib", "image_2",
                    "velodyne", "oxts", "l2e"]:
            (self.store_dir / sub).mkdir(parents=True, exist_ok=True)

    def convert(self, convert_labels=True):
        tokens = self.sample_token_list or [s["token"] for s in self.lyft_ds.sample]
        for i, token in enumerate(tokens):
            self.process_token(token, i + self.idx_offset, convert_labels)

    def process_token(self, sample_token, index, convert_labels=True):
        from .nu_tables import load_lidar

        ds = self.lyft_ds
        sample = ds.get("sample", sample_token)
        lidar_token = sample["data"][self.lidar_name]
        sd_lid = ds.get("sample_data", lidar_token)
        cs_lid = ds.get("calibrated_sensor", sd_lid["calibrated_sensor_token"])
        ego_lid = ds.get("ego_pose", sd_lid["ego_pose_token"])
        name = f"{index:06d}"

        # oxts + l2e (the MODEST multi-traversal contract)
        with open(self.store_dir / "oxts" / f"{name}.txt", "w") as f:
            f.write(oxts_line_from_pose(ego_lid["translation"], ego_lid["rotation"]))
        np.save(self.store_dir / "l2e" / f"{name}.npy",
                form_trans_mat(cs_lid["translation"], cs_lid["rotation"]))

        cam_token = sample["data"]["CAM_FRONT"]
        sd_cam = ds.get("sample_data", cam_token)
        cs_cam = ds.get("calibrated_sensor", sd_cam["calibrated_sensor_token"])
        ego_cam = ds.get("ego_pose", sd_cam["ego_pose_token"])
        h, w = sd_cam["height"], sd_cam["width"]

        lid_to_ego = transform_matrix(cs_lid["translation"], cs_lid["rotation"])
        ego_to_world = transform_matrix(ego_lid["translation"], ego_lid["rotation"])
        world_to_cam_ego = transform_matrix(ego_cam["translation"], ego_cam["rotation"], True)
        ego_to_cam = transform_matrix(cs_cam["translation"], cs_cam["rotation"], True)
        velo_to_cam = ego_to_cam @ world_to_cam_ego @ ego_to_world @ lid_to_ego
        kitti2nu = np.eye(4)
        kitti2nu[:3, :3] = quat_to_matrix([np.cos(np.pi / 2), 0, 0, np.sin(np.pi / 2)])
        velo_to_cam_kitti = velo_to_cam @ kitti2nu

        P2 = np.zeros((3, 4))
        P2[:3, :3] = cs_cam["camera_intrinsic"]
        write_kitti_calib(self.store_dir / "calib" / f"{name}.txt", P2, velo_to_cam_kitti)

        # image jpg → png
        export_png(Path(ds.data_path) / sd_cam["filename"],
                   self.store_dir / "image_2" / f"{name}.png")

        # lidar: rotate nu → KITTI frame (devkit LidarPointCloud.from_file
        # reads 5 float32s/pt and keeps x, y, z, intensity)
        pts = load_lidar(Path(ds.data_path) / sd_lid["filename"], 5)[:, :4]
        rot = quat_to_matrix([np.cos(np.pi / 2), 0, 0, -np.sin(np.pi / 2)])
        pts[:, :3] = pts[:, :3] @ rot.T
        pts.astype(np.float32).tofile(self.store_dir / "velodyne" / f"{name}.bin")

        if not convert_labels:
            return
        objects, full_range = [], []
        for ann_token in sample["anns"]:
            ann = ds.get("sample_annotation", ann_token)
            cat = ann["category_name"]
            if cat not in LYFT_CLASS_MAP:
                continue
            _, boxes, _ = ds.get_sample_data(lidar_token, selected_anntokens=[ann_token])
            box = boxes[0]
            box7 = box_nu_lidar_to_kitti_camera(
                box.center, box.wlh, box.rotation_matrix, velo_to_cam_kitti
            )
            proj = project_box_to_2d(box7, P2, h, w)
            obj = {
                "detection_name": LYFT_CLASS_MAP[cat],
                "box7": box7,
                "bbox_2d": proj["bbox"],
                "truncated": proj["truncated"],
                "alpha": -np.arctan2(box7[0], box7[2]) + box7[6],
                "depth": float(np.linalg.norm(box7[:3])),
            }
            if proj["valid"]:
                objects.append(obj)
            full_range.append(obj)
        for objs, sub in [(objects, "label_2"), (full_range, "label_2_full_range")]:
            objs = estimate_occlusions(objs, h, w)
            with open(self.store_dir / sub / f"{name}.txt", "w") as f:
                for o in objs:
                    f.write(
                        kitti_label_line(o["detection_name"], o["box7"], o["bbox_2d"],
                                         o["truncated"], o["occluded"], o["alpha"]) + "\n"
                    )


def find_closest_integer(query: int, ref_arr: np.ndarray):
    """Index/value of the closest element (reference nusc2kitti_boston.py:28-33)."""
    idx = int(np.argmin(np.abs(np.asarray(ref_arr, np.int64) - int(query))))
    return idx, int(ref_arr[idx]), abs(int(ref_arr[idx]) - int(query))


class NuscToKittiConverter:
    """nuScenes (Boston) → KITTI export (reference nusc2kitti_boston.py).

    Two export modes:
      * annotated: the 2 Hz keyframe samples (with labels);
      * full-rate: every LiDAR sweep (~20 Hz), camera frames matched by
        closest timestamp — the multi-traversal PP-score source.
    Uses the nuscenes devkit when installed; otherwise the SDK-free
    table reader (`nu_tables.NuTables`).
    """

    KITTI2NU_YAW = np.pi / 2  # nuScenes lidar is KITTI rotated by +90°

    def __init__(self, store_dir, nusc_dir, version="v1.0-trainval",
                 lidar_name="LIDAR_TOP", cam_name="CAM_FRONT",
                 scene_tokens=None, convert_labels=True, convert_images=True,
                 use_sdk="auto"):
        if use_sdk == "auto":
            try:
                from nuscenes.nuscenes import NuScenes  # noqa: F401
                use_sdk = True
            except ImportError:
                use_sdk = False
        if use_sdk:
            from nuscenes.nuscenes import NuScenes

            self.nusc = NuScenes(version=version, dataroot=nusc_dir)
        else:
            from .nu_tables import NuTables

            self.nusc = NuTables(nusc_dir, Path(nusc_dir) / version)
        self.store_dir = Path(store_dir) / "training"
        self.lidar_name = lidar_name
        self.cam_name = cam_name
        self.scene_tokens = scene_tokens
        self.convert_labels = convert_labels
        self.convert_images = convert_images
        for sub in ["label_2", "calib", "image_2", "velodyne", "oxts", "l2e"]:
            (self.store_dir / sub).mkdir(parents=True, exist_ok=True)

    def _scenes(self):
        scenes = self.nusc.scene
        if self.scene_tokens is not None:
            scenes = [s for s in scenes if s["token"] in self.scene_tokens]
        return scenes

    def samples_full_rate(self):
        """(lidar_token, cam_token) pairs at ~20 Hz + per-scene track list
        (reference _split_to_samples:502-546)."""
        samples, track_list = [], []
        cnt = 0
        for scene in self._scenes():
            track_list.append([])
            first = self.nusc.get("sample", scene["first_sample_token"])
            ld_tokens, ld_ts = [], []
            tok = first["data"][self.lidar_name]
            while tok:
                sd = self.nusc.get("sample_data", tok)
                ld_tokens.append(tok)
                ld_ts.append(sd["timestamp"])
                tok = sd["next"]
            cam_tokens, cam_ts = [], []
            tok = first["data"][self.cam_name]
            while tok:
                sd = self.nusc.get("sample_data", tok)
                cam_tokens.append(tok)
                cam_ts.append(sd["timestamp"])
                tok = sd["next"]
            cam_ts = np.array(cam_ts)
            for i, lt in enumerate(ld_tokens):
                ci, _, _ = find_closest_integer(ld_ts[i], cam_ts)
                samples.append((lt, cam_tokens[ci]))
                track_list[-1].append(cnt)
                cnt += 1
        return samples, track_list

    def samples_annotated(self):
        """2 Hz keyframes with annotation tokens (reference :548-570)."""
        tokens = {s["token"] for s in self._scenes()}
        samples, seq_map = [], {}
        cnt = 0
        for sample in self.nusc.sample:
            if sample["scene_token"] not in tokens:
                continue
            entry = [sample["data"][self.lidar_name], sample["data"][self.cam_name]]
            if self.convert_labels:
                entry.append(sample["anns"])
            samples.append(entry)
            seq_map.setdefault(sample["scene_token"], []).append(cnt)
            cnt += 1
        return samples, seq_map

    def process_pair(self, index, lidar_token, cam_token, ann_tokens=None):
        """Write one frame's velodyne/calib/image/oxts/l2e (+labels)."""
        nusc = self.nusc
        sd_lid = nusc.get("sample_data", lidar_token)
        cs_lid = nusc.get("calibrated_sensor", sd_lid["calibrated_sensor_token"])
        ego_lid = nusc.get("ego_pose", sd_lid["ego_pose_token"])
        sd_cam = nusc.get("sample_data", cam_token)
        cs_cam = nusc.get("calibrated_sensor", sd_cam["calibrated_sensor_token"])
        ego_cam = nusc.get("ego_pose", sd_cam["ego_pose_token"])
        name = f"{index:06d}"

        with open(self.store_dir / "oxts" / f"{name}.txt", "w") as f:
            f.write(oxts_line_from_pose(ego_lid["translation"], ego_lid["rotation"]))
        np.save(self.store_dir / "l2e" / f"{name}.npy",
                form_trans_mat(cs_lid["translation"], cs_lid["rotation"]))

        lid_to_ego = transform_matrix(cs_lid["translation"], cs_lid["rotation"])
        ego_to_world = transform_matrix(ego_lid["translation"], ego_lid["rotation"])
        world_to_cam_ego = transform_matrix(ego_cam["translation"], ego_cam["rotation"], True)
        ego_to_cam = transform_matrix(cs_cam["translation"], cs_cam["rotation"], True)
        velo_to_cam = ego_to_cam @ world_to_cam_ego @ ego_to_world @ lid_to_ego
        k2n = np.eye(4)
        half = self.KITTI2NU_YAW / 2
        k2n[:3, :3] = quat_to_matrix([np.cos(half), 0, 0, np.sin(half)])
        velo_to_cam_kitti = velo_to_cam @ k2n

        P2 = np.zeros((3, 4))
        P2[:3, :3] = cs_cam["camera_intrinsic"]
        write_kitti_calib(self.store_dir / "calib" / f"{name}.txt", P2, velo_to_cam_kitti)

        import os.path as osp

        pts = np.fromfile(
            osp.join(nusc.dataroot, sd_lid["filename"]), dtype=np.float32
        ).reshape(-1, 5)[:, :4]
        rot = quat_to_matrix([np.cos(-half), 0, 0, np.sin(-half)])
        pts[:, :3] = pts[:, :3] @ rot.T
        pts.astype(np.float32).tofile(self.store_dir / "velodyne" / f"{name}.bin")

        if self.convert_images:
            export_png(Path(nusc.dataroot) / sd_cam["filename"],
                       self.store_dir / "image_2" / f"{name}.png")

        if ann_tokens is None or not self.convert_labels:
            return
        h, w = sd_cam["height"], sd_cam["width"]
        objects = []
        for ann_token in ann_tokens:
            ann = nusc.get("sample_annotation", ann_token)
            if ann["category_name"] not in NUSC_CLASS_MAP:
                continue
            _, boxes, _ = nusc.get_sample_data(lidar_token, selected_anntokens=[ann_token])
            box = boxes[0]
            box7 = box_nu_lidar_to_kitti_camera(
                box.center, box.wlh, box.rotation_matrix, velo_to_cam_kitti,
                kitti_to_nu_yaw=self.KITTI2NU_YAW,
            )
            proj = project_box_to_2d(box7, P2, h, w)
            if not proj["valid"]:
                continue
            objects.append({
                "detection_name": NUSC_CLASS_MAP[ann["category_name"]],
                "box7": box7,
                "bbox_2d": proj["bbox"],
                "truncated": proj["truncated"],
                "alpha": -np.arctan2(box7[0], box7[2]) + box7[6],
                "depth": float(np.linalg.norm(box7[:3])),
            })
        objects = estimate_occlusions(objects, h, w)
        with open(self.store_dir / "label_2" / f"{name}.txt", "w") as f:
            for o in objects:
                f.write(kitti_label_line(o["detection_name"], o["box7"], o["bbox_2d"],
                                         o["truncated"], o["occluded"], o["alpha"]) + "\n")


def kitti_res_to_nuscenes_box(box7_cam, velo_to_cam_kitti, kitti_to_nu_yaw=np.pi / 2):
    """Camera-frame KITTI result box → nu-lidar-frame (center, wlh, yaw).

    Inverse of box_nu_lidar_to_kitti_camera (reference kitti_res_to_nuscenes
    :431-479 round-trips detector results back into nuScenes submissions).
    """
    x, y, z, l, h, w, ry = np.asarray(box7_cam, np.float64)
    nu_to_kitti = np.eye(4)
    c, s = np.cos(-kitti_to_nu_yaw), np.sin(-kitti_to_nu_yaw)
    nu_to_kitti[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    T = velo_to_cam_kitti @ nu_to_kitti
    Ti = np.linalg.inv(T)
    center_cam = np.array([x, y - h / 2, z])  # bottom → true center
    center_nu = Ti[:3, :3] @ center_cam + Ti[:3, 3]
    # camera-frame heading ry → rotation matrix → nu frame yaw
    cr, sr = np.cos(-ry), np.sin(-ry)
    rot_cam = np.array([[cr, 0.0, -sr], [0.0, 1.0, 0.0], [sr, 0.0, cr]])
    rot_nu = Ti[:3, :3] @ rot_cam @ T[:3, :3]
    yaw = np.arctan2(rot_nu[1, 0], rot_nu[0, 0])
    return center_nu, (w, l, h), yaw
