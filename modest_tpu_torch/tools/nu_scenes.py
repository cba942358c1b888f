"""A synthetic nuScenes-schema (Lyft-layout) dataset of repeated drives, for
running the dataset-preparation CLIs end to end without real data or PIL.

``write_traversal_tables`` writes the JSON tables that
``preprocessing/nu_tables.py`` (and the devkits) read, 5-float lidar sweeps
and camera frames, the way ``tests/test_nu_tables.py`` builds its one-scene
set, but with ``traversals`` scenes that drive the same straight road along
+x, so that ``split_traintest`` finds every origin's other traversals and
the PP score has past drives to compare with. Every sweep is a keyframe (as
Lyft's are) with one annotated car ahead of the ego. The static world (a
ground plane at z = 0 and a wall beside the road) is the same for every
drive; each drive adds its own cars. Camera frames are PNG headers without
pixel data; ``write_kitti_images`` writes the same headers into the KITTI
store's ``image_2``, so the export finds its images converted and loads no
image library.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .synth_kitti import write_png_header

# CAM_FRONT sensor→ego: cam x = right (-y ego), y = down (-z ego), z = forward (+x ego)
CAM_ROT_QUAT = [0.5, -0.5, 0.5, -0.5]  # (w, x, y, z) of that rotation
CAM_INTRINSIC = [[700.0, 0.0, 600.0], [0.0, 700.0, 200.0], [0.0, 0.0, 1.0]]
IMG_W, IMG_H = 1200, 400
LIDAR_T = [0.9, 0.0, 1.8]  # lidar above the ego origin, which sits on the ground
CAM_T = [1.7, 0.0, 1.5]


def _yaw_quat(yaw):
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def _world(rng, length, n_ground, n_wall):
    """Static world points (x, y, z): the road's ground and a wall at y = 12,
    reaching 80 m past both ends of the drive, so that every sweep sees
    about the same number of points (half of them)."""
    ground = np.stack([rng.uniform(-80, length + 80, n_ground),
                       rng.uniform(-15, 15, n_ground), rng.normal(0.0, 0.02, n_ground)], 1)
    wall = np.stack([rng.uniform(-80, length + 80, n_wall), 12.0 + rng.normal(0, 0.05, n_wall),
                     rng.uniform(0.0, 3.0, n_wall)], 1)
    return np.concatenate([ground, wall])


def write_traversal_tables(root, *, traversals=3, frames=40, spacing=2.0, n_ground=48000,
                           n_wall=6000, n_cars=4, car_points=300, seed=0):
    """Write the tables under ``root / "v1.0-trainval"`` and the sweeps and
    camera frames under ``root``. Scene s drives frames sweeps ``spacing``
    m apart at lateral offset 0.5·s; each sweep sees the points within 60 m
    of the ego. Returns (table_dir, track_list): the sample order the
    converters export, as global frame indices per scene."""
    root = Path(root)
    table_dir = root / "v1.0-trainval"
    for d in (table_dir, root / "lidar", root / "images"):
        d.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    static = _world(rng, frames * spacing, n_ground, n_wall)
    T = {n: [] for n in ("category", "instance", "sensor", "calibrated_sensor", "ego_pose",
                         "log", "scene", "sample", "sample_data", "sample_annotation",
                         "attribute", "visibility", "map")}
    T["category"].append({"token": "cat0", "name": "car", "description": ""})
    T["sensor"] += [{"token": "sen_lid", "channel": "LIDAR_TOP", "modality": "lidar"},
                    {"token": "sen_cam", "channel": "CAM_FRONT", "modality": "camera"}]
    T["calibrated_sensor"] += [
        {"token": "cs_lid", "sensor_token": "sen_lid", "translation": LIDAR_T,
         "rotation": _yaw_quat(0.0), "camera_intrinsic": []},
        {"token": "cs_cam", "sensor_token": "sen_cam", "translation": CAM_T,
         "rotation": CAM_ROT_QUAT, "camera_intrinsic": CAM_INTRINSIC}]
    track_list, gid = [], 0
    for s in range(traversals):
        # this drive's parked and moving cars: boxes of points on the road
        cars = rng.uniform([0, -6, 0.0], [frames * spacing + 60, 6, 0.0], (n_cars, 3))
        car_pts = np.concatenate([c + rng.uniform(-1, 1, (car_points, 3)) * [2.0, 0.9, 0.75]
                                  + [0, 0, 0.75] for c in cars])
        world = np.concatenate([static, car_pts])
        samples = [f"s{s}_{f}" for f in range(frames)]
        T["scene"].append({"token": f"scene{s}", "log_token": "log0", "nbr_samples": frames,
                           "first_sample_token": samples[0], "last_sample_token": samples[-1],
                           "name": f"scene-{s:04d}", "description": ""})
        track_list.append([])
        for f in range(frames):
            t_us = 1_000_000 * (s + 1) + f * 100_000
            ego_t = np.array([f * spacing, 0.5 * s, 0.0])
            tok = samples[f]
            T["sample"].append({"token": tok, "scene_token": f"scene{s}", "timestamp": t_us,
                                "prev": samples[f - 1] if f else "",
                                "next": samples[f + 1] if f + 1 < frames else ""})
            T["ego_pose"] += [{"token": f"ego_{tok}", "timestamp": t_us,
                               "translation": ego_t.tolist(), "rotation": _yaw_quat(0.0)},
                              {"token": f"egocam_{tok}", "timestamp": t_us + 1,
                               "translation": ego_t.tolist(), "rotation": _yaw_quat(0.0)}]
            sensor = world - ego_t - np.asarray(LIDAR_T)  # identity rotations
            sensor = sensor[np.linalg.norm(sensor[:, :2], axis=1) < 60.0]
            pts = np.zeros((len(sensor), 5), np.float32)
            pts[:, :3] = sensor
            pts[:, 3] = rng.uniform(0, 1, len(sensor))
            pts[:, 4] = rng.randint(0, 40, len(sensor))
            lid_fn, cam_fn = f"lidar/{tok}.bin", f"images/{tok}.png"
            pts.tofile(root / lid_fn)
            write_png_header(root / cam_fn, IMG_H, IMG_W)
            T["sample_data"] += [
                {"token": f"lid_{tok}", "sample_token": tok, "ego_pose_token": f"ego_{tok}",
                 "calibrated_sensor_token": "cs_lid", "timestamp": t_us, "fileformat": "bin",
                 "is_key_frame": True, "height": 0, "width": 0, "filename": lid_fn,
                 "prev": f"lid_{samples[f - 1]}" if f else "",
                 "next": f"lid_{samples[f + 1]}" if f + 1 < frames else ""},
                {"token": f"cam_{tok}", "sample_token": tok, "ego_pose_token": f"egocam_{tok}",
                 "calibrated_sensor_token": "cs_cam", "timestamp": t_us + 1,
                 "fileformat": "png", "is_key_frame": True, "height": IMG_H, "width": IMG_W,
                 "filename": cam_fn, "prev": f"cam_{samples[f - 1]}" if f else "",
                 "next": f"cam_{samples[f + 1]}" if f + 1 < frames else ""}]
            inst = f"inst_{tok}"
            T["instance"].append({"token": inst, "category_token": "cat0",
                                  "nbr_annotations": 1, "first_annotation_token": f"ann_{tok}",
                                  "last_annotation_token": f"ann_{tok}"})
            T["sample_annotation"].append({
                "token": f"ann_{tok}", "sample_token": tok, "instance_token": inst,
                "visibility_token": "", "attribute_tokens": [],
                "translation": (ego_t + [12.0, 0.5, 0.85]).tolist(), "size": [1.9, 4.5, 1.7],
                "rotation": _yaw_quat(0.1), "prev": "", "next": "", "num_lidar_pts": 50,
                "num_radar_pts": 0})
            track_list[-1].append(gid)
            gid += 1
    T["log"].append({"token": "log0", "logfile": "", "vehicle": "v", "date_captured": "",
                     "location": "synthetic"})
    for name, rows in T.items():
        (table_dir / f"{name}.json").write_text(json.dumps(rows))
    return table_dir, track_list


def write_kitti_images(store_dir, n: int):
    """The ``image_2`` PNGs of ``n`` exported frames (headers of the camera
    size), so the converters find their images done."""
    image_dir = Path(store_dir) / "training" / "image_2"
    image_dir.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        write_png_header(image_dir / f"{i:06d}.png", IMG_H, IMG_W)
