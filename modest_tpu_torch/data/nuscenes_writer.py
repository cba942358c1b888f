"""nuScenes info building + detection submission writing — port of
``modest_tpu/data/nuscenes_writer.py``.

Reference: pcdet/datasets/nuscenes/nuscenes_utils.py (500 LoC). The SE(3)
math reuses the port's preprocessing/converters.py (quat_to_matrix /
transform_matrix — SDK-free); only the raw-tree traversal needs the
`nuscenes` devkit, so every function that takes a `nusc` handle is
SDK-gated at its caller.
"""
from __future__ import annotations

from functools import reduce
from pathlib import Path

import numpy as np

from ..preprocessing.converters import quat_to_matrix, transform_matrix

# general category → detection-challenge class (standard nuScenes mapping)
NAME_MAP = {
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.wheelchair": "ignore",
    "human.pedestrian.stroller": "ignore",
    "human.pedestrian.personal_mobility": "ignore",
    "human.pedestrian.police_officer": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "animal": "ignore",
    "vehicle.car": "car",
    "vehicle.motorcycle": "motorcycle",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.truck": "truck",
    "vehicle.construction": "construction_vehicle",
    "vehicle.emergency.ambulance": "ignore",
    "vehicle.emergency.police": "ignore",
    "vehicle.trailer": "trailer",
    "movable_object.barrier": "barrier",
    "movable_object.trafficcone": "traffic_cone",
    "movable_object.pushable_pullable": "ignore",
    "movable_object.debris": "ignore",
    "static_object.bicycle_rack": "ignore",
}

# majority attribute per class for stationary/unknown detections — same
# intent as the reference's argmax over its vendored per-class attribute
# histogram (nuscenes_utils.cls_attr_dist), expressed as the well-known
# fixed table instead of the 200-line count dump
DEFAULT_ATTR = {
    "car": "vehicle.parked",
    "pedestrian": "pedestrian.moving",
    "trailer": "vehicle.parked",
    "truck": "vehicle.parked",
    "bus": "vehicle.moving",
    "motorcycle": "cycle.without_rider",
    "construction_vehicle": "vehicle.parked",
    "bicycle": "cycle.without_rider",
    "barrier": "",
    "traffic_cone": "",
}


def quaternion_yaw(q_wxyz) -> float:
    """Yaw of a lidar/global-frame quaternion (reference :234-249)."""
    rot = quat_to_matrix(np.asarray(q_wxyz, np.float64))
    v = rot @ np.array([1.0, 0.0, 0.0])
    return float(np.arctan2(v[1], v[0]))


def _yaw_quat_wxyz(yaw: float) -> list:
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def _quat_mul(a, b):
    """Hamilton product of two wxyz quaternions."""
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return [
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ]


def fill_trainval_infos(nusc, train_scenes, val_scenes, test=False, max_sweeps=10):
    """Walk nusc.sample, building the info schema the datasets load
    (reference fill_trainval_infos:252-380). Requires the devkit handle."""
    train_scene_tokens = {
        s["token"] for s in nusc.scene if s["name"] in set(train_scenes)
    }
    data_path = Path(nusc.dataroot)
    train_infos, val_infos = [], []

    for sample in nusc.sample:
        ref_sd_token = sample["data"]["LIDAR_TOP"]
        ref_sd = nusc.get("sample_data", ref_sd_token)
        ref_cs = nusc.get("calibrated_sensor", ref_sd["calibrated_sensor_token"])
        ref_pose = nusc.get("ego_pose", ref_sd["ego_pose_token"])
        ref_time = 1e-6 * ref_sd["timestamp"]
        ref_lidar_path = nusc.get_sample_data_path(ref_sd_token)

        ref_from_car = transform_matrix(
            ref_cs["translation"], ref_cs["rotation"], inverse=True
        )
        car_from_global = transform_matrix(
            ref_pose["translation"], ref_pose["rotation"], inverse=True
        )

        info = {
            "lidar_path": str(Path(ref_lidar_path).relative_to(data_path)),
            "token": sample["token"],
            "sweeps": [],
            "ref_from_car": ref_from_car,
            "car_from_global": car_from_global,
            "timestamp": ref_time,
        }

        # walk backwards through the 20 Hz sweeps, mapping each into the
        # keyframe lidar frame
        curr = ref_sd
        sweeps = []
        while len(sweeps) < max_sweeps - 1:
            if curr["prev"] == "":
                if len(sweeps) == 0:
                    sweeps.append({
                        "lidar_path": info["lidar_path"],
                        "sample_data_token": curr["token"],
                        "transform_matrix": None,
                        "time_lag": 0.0,
                    })
                else:
                    sweeps.append(sweeps[-1])
            else:
                curr = nusc.get("sample_data", curr["prev"])
                pose = nusc.get("ego_pose", curr["ego_pose_token"])
                cs = nusc.get("calibrated_sensor", curr["calibrated_sensor_token"])
                global_from_car = transform_matrix(
                    pose["translation"], pose["rotation"], inverse=False
                )
                car_from_current = transform_matrix(
                    cs["translation"], cs["rotation"], inverse=False
                )
                tm = reduce(np.dot, [ref_from_car, car_from_global,
                                     global_from_car, car_from_current])
                sweeps.append({
                    "lidar_path": str(Path(
                        nusc.get_sample_data_path(curr["token"])
                    ).relative_to(data_path)),
                    "sample_data_token": curr["token"],
                    "transform_matrix": tm,
                    "time_lag": ref_time - 1e-6 * curr["timestamp"],
                })
        info["sweeps"] = sweeps

        if not test:
            annos = [nusc.get("sample_annotation", t) for t in sample["anns"]]
            num_lidar = np.array([a["num_lidar_pts"] for a in annos])
            num_radar = np.array([a["num_radar_pts"] for a in annos])
            mask = (num_lidar + num_radar) > 0

            locs, dims, rots, vels, names = [], [], [], [], []
            for a in annos:
                # global → keyframe lidar frame
                center = np.asarray(a["translation"] + [1.0])
                center_l = (ref_from_car @ car_from_global @ center)[:3]
                locs.append(center_l)
                w, l, h = a["size"]
                dims.append([l, w, h])  # wlh → dx dy dz
                # rotation: compose lidar←global with the box quaternion
                rq = a["rotation"]
                # lidar-frame yaw = global yaw rotated by lidar←global
                rot_l = (ref_from_car @ car_from_global)[:3, :3] @ quat_to_matrix(
                    np.asarray(rq, np.float64))
                v = rot_l @ np.array([1.0, 0.0, 0.0])
                rots.append(np.arctan2(v[1], v[0]))
                vel = np.asarray(
                    nusc.box_velocity(a["token"]), np.float64)  # global (3,)
                vel = np.nan_to_num(vel)
                vel_l = (ref_from_car @ car_from_global)[:3, :3] @ vel
                vels.append(vel_l[:2])
                names.append(NAME_MAP.get(a["category_name"], "ignore"))
            gt_boxes = np.concatenate([
                np.asarray(locs).reshape(-1, 3),
                np.asarray(dims).reshape(-1, 3),
                np.asarray(rots).reshape(-1, 1),
                np.asarray(vels).reshape(-1, 2),
            ], axis=1) if annos else np.zeros((0, 9))
            info["gt_boxes"] = gt_boxes[mask]
            info["gt_names"] = np.asarray(names)[mask]
            info["gt_boxes_token"] = np.asarray([a["token"] for a in annos])[mask]
            info["num_lidar_pts"] = num_lidar[mask]
            info["num_radar_pts"] = num_radar[mask]

        if sample["scene_token"] in train_scene_tokens:
            train_infos.append(info)
        else:
            val_infos.append(info)
    return train_infos, val_infos


def transform_det_annos_to_nusc_annos(det_annos, nusc):
    """Lidar-frame detections → global-frame nuScenes submission dicts
    (reference :383-468): per box, lidar→ego→global SE(3), velocity-based
    attribute choice, majority attribute for stationary detections."""
    results = {}
    for det in det_annos:
        token = det["metadata"]["token"]
        s_rec = nusc.get("sample", token)
        sd = nusc.get("sample_data", s_rec["data"]["LIDAR_TOP"])
        cs = nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
        pose = nusc.get("ego_pose", sd["ego_pose_token"])
        ego_from_lidar = transform_matrix(cs["translation"], cs["rotation"])
        global_from_ego = transform_matrix(pose["translation"], pose["rotation"])
        g_from_l = global_from_ego @ ego_from_lidar

        annos = []
        boxes = np.asarray(det["boxes_lidar"])
        for k in range(boxes.shape[0]):
            b = boxes[k]
            center = (g_from_l @ np.array([b[0], b[1], b[2], 1.0]))[:3]
            vel = (b[7], b[8], 0.0) if boxes.shape[1] >= 9 else (0.0, 0.0, 0.0)
            vel_g = g_from_l[:3, :3] @ np.asarray(vel)
            yaw_q = _yaw_quat_wxyz(float(b[6]))
            rot_g = _quat_mul(list(np.asarray(pose["rotation"], np.float64)),
                              _quat_mul(list(np.asarray(cs["rotation"], np.float64)),
                                        yaw_q))
            name = str(det["name"][k])
            speed = float(np.hypot(vel_g[0], vel_g[1]))
            if speed > 0.2:
                if name in ("car", "construction_vehicle", "bus", "truck", "trailer"):
                    attr = "vehicle.moving"
                elif name in ("bicycle", "motorcycle"):
                    attr = "cycle.with_rider"
                else:
                    attr = DEFAULT_ATTR.get(name, "")
            else:
                if name == "pedestrian":
                    attr = "pedestrian.standing"
                elif name == "bus":
                    attr = "vehicle.stopped"
                else:
                    attr = DEFAULT_ATTR.get(name, "")
            annos.append({
                "sample_token": token,
                "translation": center.tolist(),
                "size": [float(b[4]), float(b[3]), float(b[5])],  # wlh
                "rotation": [float(v) for v in rot_g],
                "velocity": [float(vel_g[0]), float(vel_g[1])],
                "detection_name": name,
                "detection_score": float(det["score"][k]),
                "attribute_name": attr,
            })
        results[token] = annos
    return {"results": results, "meta": None}
