"""Synthetic nuScenes and Waymo trees from a seed, in the layouts the
port's ``data/nuscenes_dataset.py`` and ``data/waymo_dataset.py`` read.

``write_nuscenes_tree`` writes ``samples/`` and ``sweeps/`` ``.pcd.bin``
files of (N, 5) float32 (x, y, z, intensity, ring), each sweep's 4x4
sweep-to-keyframe transform and time lag in the infos pkl, gt boxes (M, 9)
[x y z dx dy dz heading vx vy] with names of the ten CBGS classes and
``num_lidar_pts``. ``write_waymo_tree`` writes
``waymo_processed_data/<sequence>/<idx:04d>.npy`` files of (N, 6) rows
[x, y, z, intensity, elongation, NLZ flag] (flag -1 outside a no-label
zone), ``ImageSets/{train,val}.txt`` and each sequence's infos pkl with
``annos`` (``name`` with ``unknown`` among them, ``gt_boxes_lidar``,
``num_points_in_gt``, ``difficulty``). ``*_gt_database`` build the dbinfos
pkl that ``gt_sampling`` reads, through the dataset classes.

Left at their defaults the two writers make the tiny trees of
``tests/test_nuscenes_waymo.py::make_nusc_tree`` / ``make_waymo_tree``, file
for file. ``full_density`` makes frames of a real scan's size: nuScenes
keyframes and sweeps of ~34,000 points (10 sweeps a frame), Waymo frames of
~180,000 points before the NLZ drop, so the configs' ``sample_points``
(65536 and 131072) draw without replacement, as on real data. Objects are
boxes filled with points on a ground plane; they move between sweeps at
their velocity while the ego drives forward.

    python -m modest_tpu_torch.tools.synth_infos nuscenes <root> --frames 8 --full_density
    python -m modest_tpu_torch.tools.synth_infos waymo <root> --frames 8 --full_density
"""
from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np

# (l, w, h) of each CBGS class: the configs' anchor sizes; points on a
# full-density keyframe object, and its share of moving objects
NUSC_SIZES = {
    "car": (4.63, 1.97, 1.74), "truck": (6.93, 2.51, 2.84),
    "construction_vehicle": (6.37, 2.85, 3.19), "bus": (10.5, 2.94, 3.47),
    "trailer": (12.29, 2.90, 3.87), "barrier": (0.50, 2.53, 0.98),
    "motorcycle": (2.11, 0.77, 1.47), "bicycle": (1.70, 0.60, 1.28),
    "pedestrian": (0.73, 0.67, 1.77), "traffic_cone": (0.41, 0.41, 1.07),
}
NUSC_OBJECT_POINTS = {"car": 300, "truck": 400, "construction_vehicle": 350, "bus": 500,
                      "trailer": 450, "barrier": 60, "motorcycle": 80, "bicycle": 60,
                      "pedestrian": 50, "traffic_cone": 25}
NUSC_STATIC = ("barrier", "traffic_cone")
NUSC_FULL = {"points": 34000, "sweeps": 10, "objects": (14, 26), "xy": 45.0,
             "ground_z": -1.8, "ego_speed": 5.0, "sweep_dt": 0.05}
WAYMO_SIZES = {"Vehicle": (4.7, 2.1, 1.7), "Pedestrian": (0.91, 0.86, 1.73),
               "Cyclist": (1.78, 0.84, 1.78), "unknown": (0.6, 0.6, 2.5)}
WAYMO_OBJECT_POINTS = {"Vehicle": 900, "Pedestrian": 150, "Cyclist": 200, "unknown": 60}
WAYMO_FULL = {"points": 180000, "objects": (20, 36), "xy": 70.0, "ground_z": 0.0,
              "nlz_share": 0.03}


def _box_points(rng, box, n):
    """``n`` points uniform in the rotated ``box`` [x y z l w h heading]."""
    local = rng.uniform(-0.5, 0.5, (n, 3)) * box[3:6]
    c, s = np.cos(box[6]), np.sin(box[6])
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    return local @ rot.T + box[:3]


def _objects(rng, sizes, n_range, xy, ground_z):
    """Random (names, boxes (M, 7)) of ``sizes``' classes on the ground,
    their centres within ``xy`` of the ego and 3 m clear of it."""
    names = list(sizes)
    m = rng.randint(*n_range)
    picked = [names[i] for i in rng.randint(len(names), size=m)]
    boxes = np.zeros((m, 7))
    for i, name in enumerate(picked):
        l, w, h = np.asarray(sizes[name]) * rng.uniform(0.9, 1.1, 3)
        r = rng.uniform(3.0, xy)
        a = rng.uniform(-np.pi, np.pi)
        boxes[i] = [r * np.cos(a), r * np.sin(a), ground_z + h / 2, l, w, h,
                    rng.uniform(-np.pi, np.pi)]
    return picked, boxes


def _ground(rng, n, xy, ground_z):
    r = xy * np.sqrt(rng.uniform(0, 1, n))
    a = rng.uniform(-np.pi, np.pi, n)
    return np.stack([r * np.cos(a), r * np.sin(a), ground_z + 0.02 * rng.randn(n)], 1)


# ---------------------------------------------------------------------------
# nuScenes
# ---------------------------------------------------------------------------


def _tiny_nuscenes(root, n_frames, n_sweeps, rng):
    infos = []
    for i in range(n_frames):
        pts = rng.uniform(-40, 40, (500, 5)).astype(np.float32)
        path = f"samples/frame_{i}.pcd.bin"
        pts.tofile(root / path)
        sweeps = []
        for s in range(n_sweeps):
            spts = rng.uniform(-40, 40, (200, 5)).astype(np.float32)
            spath = f"sweeps/frame_{i}_{s}.pcd.bin"
            spts.tofile(root / spath)
            tm = np.eye(4)
            tm[:3, 3] = [0.1 * s, 0, 0]
            sweeps.append({"lidar_path": spath, "transform_matrix": tm,
                           "time_lag": 0.05 * (s + 1)})
        n_gt = 2 + (i % 2)
        gt = np.zeros((n_gt, 9), np.float32)
        gt[:, 0:2] = rng.uniform(-30, 30, (n_gt, 2))
        gt[:, 2] = -1.0
        gt[:, 3:6] = [4.5, 2.0, 1.7]
        gt[:, 6] = rng.uniform(-3, 3, n_gt)
        gt[:, 7:9] = rng.uniform(-5, 5, (n_gt, 2))
        names = np.asarray(["car"] * (n_gt - 1) + ["pedestrian"])
        infos.append({
            "lidar_path": path, "token": f"tok{i}", "sweeps": sweeps,
            "gt_boxes": gt, "gt_names": names,
            "num_lidar_pts": np.full(n_gt, 10 + i),
        })
    return infos


def _sweep_transform(lag, speed):
    """Sweep lidar → keyframe lidar: the ego was ``speed * lag`` behind and
    turned by 0.02 rad a second less."""
    yaw = -0.02 * lag
    tm = np.eye(4)
    tm[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
    tm[0, 3] = -speed * lag
    return tm


def _full_nuscenes_frame(root, i, rng, cfg):
    names, boxes = _objects(rng, NUSC_SIZES, cfg["objects"], cfg["xy"], cfg["ground_z"])
    m = len(names)
    vel = rng.uniform(-8, 8, (m, 2))
    vel[[n in NUSC_STATIC for n in names]] = 0.0
    vel[rng.uniform(0, 1, m) < 0.1] = np.nan  # the devkit's unknown velocity
    hidden = rng.uniform(0, 1, m) < 0.1  # occluded: no lidar point
    motion = np.nan_to_num(vel)
    scale = cfg["points"] / NUSC_FULL["points"]  # object and ego points scale with the sweep
    counts = np.array([0 if h else max(int(NUSC_OBJECT_POINTS[n] * scale), 1)
                       for n, h in zip(names, hidden)])
    n_ego = int(150 * scale)

    def cloud(lag):
        """One sweep's (N, 5) points in the keyframe frame at time ``-lag``."""
        parts = [_ground(rng, cfg["points"] - int(counts.sum()) - n_ego, cfg["xy"] + 5,
                         cfg["ground_z"])]
        for k in range(m):
            box = boxes[k].copy()
            box[:2] -= motion[k] * lag
            parts.append(_box_points(rng, box, counts[k]))
        parts.append(rng.uniform(-0.9, 0.9, (n_ego, 3)) * [1, 1, 0.5])  # the ego's own roof
        xyz = np.concatenate(parts)
        rest = np.stack([rng.uniform(0, 255, len(xyz)), rng.randint(0, 32, len(xyz))], 1)
        return np.concatenate([xyz, rest], 1)

    key = cloud(0.0)
    path = f"samples/LIDAR_TOP/frame_{i:04d}.pcd.bin"
    key.astype(np.float32).tofile(root / path)
    sweeps = []
    for s in range(1, cfg["sweeps"]):
        lag = cfg["sweep_dt"] * s
        tm = _sweep_transform(lag, cfg["ego_speed"])
        pts = cloud(lag)
        inv = np.linalg.inv(tm)
        pts[:, :3] = pts[:, :3] @ inv[:3, :3].T + inv[:3, 3]
        spath = f"sweeps/LIDAR_TOP/frame_{i:04d}_{s}.pcd.bin"
        pts.astype(np.float32).tofile(root / spath)
        sweeps.append({"lidar_path": spath, "sample_data_token": f"sd{i}_{s}",
                       "transform_matrix": tm, "time_lag": lag})
    from ..utils.box_np import points_in_boxes_mask

    gt = np.concatenate([boxes, vel], 1).astype(np.float32)
    inside = points_in_boxes_mask(key[:, :3].astype(np.float32), gt[:, :7])
    return {"lidar_path": path, "token": f"tok{i}", "sweeps": sweeps,
            "gt_boxes": gt, "gt_names": np.asarray(names),
            "num_lidar_pts": inside.sum(1).astype(np.int64),
            "timestamp": 1.5e9 + 0.5 * i}


def write_nuscenes_tree(root, n_frames=3, n_sweeps=2, rng=None, *, full_density=False,
                        n_val=0, points=None):
    """Write a nuScenes tree under ``root`` and return its train infos.
    Tiny (the default): ``tests/test_nuscenes_waymo.py::make_nusc_tree``'s
    files and ``infos_train.pkl``. ``full_density``: ``n_frames`` train and
    ``n_val`` val frames of ``NUSC_FULL`` (10 sweeps of ~34,000 points), in
    ``nuscenes_infos_{train,val}_10sweeps_withvelo.pkl``; ``points`` sets
    another sweep size (the CPU tests take a few thousand)."""
    rng = rng or np.random.RandomState(0)
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    if not full_density:
        (root / "sweeps").mkdir(exist_ok=True)
        (root / "samples").mkdir(exist_ok=True)
        infos = _tiny_nuscenes(root, n_frames, n_sweeps, rng)
        with open(root / "infos_train.pkl", "wb") as f:
            pickle.dump(infos, f)
        return infos
    (root / "samples" / "LIDAR_TOP").mkdir(parents=True, exist_ok=True)
    (root / "sweeps" / "LIDAR_TOP").mkdir(parents=True, exist_ok=True)
    cfg = {**NUSC_FULL, **({"points": points} if points else {})}
    frames = [_full_nuscenes_frame(root, i, rng, cfg) for i in range(n_frames + n_val)]
    for split, part in (("train", frames[:n_frames]), ("val", frames[n_frames:])):
        with open(root / f"nuscenes_infos_{split}_10sweeps_withvelo.pkl", "wb") as f:
            pickle.dump(part, f)
    return frames[:n_frames]


def nuscenes_gt_database(root, dataset_cfg, class_names, info_file, max_sweeps=10):
    """The dbinfos pkl and ``gt_database_<N>sweeps_withvelo/`` of the frames
    in ``root/info_file``, by ``NuScenesDataset.create_groundtruth_database``."""
    from ..data.nuscenes_dataset import NuScenesDataset
    from ..utils.config import Config

    cfg = Config({**dataset_cfg, "INFO_PATH": {"train": [info_file], "test": [info_file]}})
    cfg.pop("VERSION", None)
    cfg.pop("DATA_AUGMENTOR", None)
    cfg["BALANCED_RESAMPLING"] = False
    ds = NuScenesDataset(cfg, class_names, training=False, root_path=root)
    return ds.create_groundtruth_database(max_sweeps=max_sweeps)


# ---------------------------------------------------------------------------
# Waymo
# ---------------------------------------------------------------------------


def _tiny_waymo(root, n_frames, rng):
    seq = "segment-1234"
    d = root / "waymo_processed_data" / seq
    d.mkdir(parents=True, exist_ok=True)
    (root / "ImageSets").mkdir(exist_ok=True)
    (root / "ImageSets" / "train.txt").write_text(f"{seq}.tfrecord\n")
    infos = []
    for i in range(n_frames):
        pts = np.zeros((400, 6), np.float32)
        pts[:, :3] = rng.uniform(-60, 60, (400, 3))
        pts[:, 3] = rng.uniform(0, 1, 400)
        pts[:, 5] = -1  # in lidar zone
        pts[:50, 5] = 1  # no-label-zone points must be dropped
        np.save(d / f"{i:04d}.npy", pts)
        boxes = np.zeros((2, 7), np.float32)
        boxes[:, 0:2] = rng.uniform(-40, 40, (2, 2))
        boxes[:, 3:6] = [4.7, 2.1, 1.7]
        infos.append({
            "point_cloud": {"lidar_sequence": seq, "sample_idx": i},
            "frame_id": f"{seq}_{i:03d}",
            "annos": {"name": np.asarray(["Vehicle", "unknown"]),
                      "gt_boxes_lidar": boxes},
        })
    with open(d / f"{seq}.pkl", "wb") as f:
        pickle.dump(infos, f)
    return infos


def _full_waymo_frame(seq, i, rng, cfg):
    names, boxes = _objects(rng, WAYMO_SIZES, cfg["objects"], cfg["xy"], cfg["ground_z"])
    hidden = rng.uniform(0, 1, len(names)) < 0.08
    sparse = rng.uniform(0, 1, len(names)) < 0.2  # far or occluded: LEVEL_2 by count
    scale = cfg["points"] / WAYMO_FULL["points"]
    counts = np.array([0 if h else (4 if s else max(int(WAYMO_OBJECT_POINTS[n] * scale), 6))
                       for n, h, s in zip(names, hidden, sparse)])
    xyz = np.concatenate([_ground(rng, cfg["points"] - int(counts.sum()), cfg["xy"] + 5,
                                  cfg["ground_z"])]
                         + [_box_points(rng, boxes[k], counts[k]) for k in range(len(names))])
    n = len(xyz)
    nlz = np.where(rng.uniform(0, 1, n) < cfg["nlz_share"], rng.randint(0, 4, n), -1)
    feats = np.concatenate([xyz, rng.uniform(0, 2, (n, 1)), rng.uniform(0, 1, (n, 1)),
                            nlz[:, None]], 1).astype(np.float32)
    from ..utils.box_np import points_in_boxes_mask

    inside = points_in_boxes_mask(xyz.astype(np.float32), boxes.astype(np.float32))
    difficulty = np.where(rng.uniform(0, 1, len(names)) < 0.1, 2, 0)
    info = {
        "point_cloud": {"num_features": 5, "lidar_sequence": seq, "sample_idx": i},
        "frame_id": f"{seq}_{i:03d}",
        "metadata": {"context_name": seq, "timestamp_micros": 1_500_000_000_000_000 + i * 100_000},
        "annos": {"name": np.asarray(names), "gt_boxes_lidar": boxes.astype(np.float32),
                  "num_points_in_gt": inside.sum(1).astype(np.int64),
                  "difficulty": difficulty.astype(np.int64)},
    }
    return feats, info


def write_waymo_tree(root, n_frames=4, rng=None, *, full_density=False, n_val=0, points=None):
    """Write a Waymo tree under ``root`` and return the train sequence's
    infos. Tiny (the default): ``tests/test_nuscenes_waymo.py::make_waymo_tree``'s
    files. ``full_density``: a train sequence of ``n_frames`` frames and a
    val sequence of ``n_val`` of ``WAYMO_FULL`` (~180,000 points, about 3 %
    of them in a no-label zone), with ``ImageSets/{train,val}.txt``;
    ``points`` sets another frame size."""
    rng = rng or np.random.RandomState(0)
    root = Path(root)
    if not full_density:
        return _tiny_waymo(root, n_frames, rng)
    (root / "ImageSets").mkdir(parents=True, exist_ok=True)
    cfg = {**WAYMO_FULL, **({"points": points} if points else {})}
    out = None
    for split, seq, count in (("train", "segment-0000_with_camera_labels", n_frames),
                              ("val", "segment-0001_with_camera_labels", n_val)):
        d = root / "waymo_processed_data" / seq
        d.mkdir(parents=True, exist_ok=True)
        (root / "ImageSets" / f"{split}.txt").write_text(f"{seq}.tfrecord\n")
        infos = []
        for i in range(count):
            feats, info = _full_waymo_frame(seq, i, rng, cfg)
            np.save(d / f"{i:04d}.npy", feats)
            infos.append(info)
        with open(d / f"{seq}.pkl", "wb") as f:
            pickle.dump(infos, f)
        out = infos if out is None else out
    return out


def waymo_gt_database(root, dataset_cfg, class_names, sampled_interval=10):
    """``pcdet_waymo_dbinfos_train_sampled_<k>.pkl`` and its point files, by
    ``WaymoDataset.create_groundtruth_database`` over the train split's
    every frame (SAMPLED_INTERVAL 1) and then every ``sampled_interval``-th."""
    from ..data.waymo_dataset import WaymoDataset
    from ..utils.config import Config

    cfg = Config({**dataset_cfg, "SAMPLED_INTERVAL": {"train": 1, "test": 1},
                  "DATA_SPLIT": {"train": "train", "test": "train"}})
    cfg.pop("DATA_AUGMENTOR", None)
    ds = WaymoDataset(cfg, class_names, training=False, root_path=root)
    return ds.create_groundtruth_database(split="train", sampled_interval=sampled_interval)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("dataset", choices=["nuscenes", "waymo"])
    parser.add_argument("root")
    parser.add_argument("--frames", type=int, default=4)
    parser.add_argument("--val_frames", type=int, default=0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--full_density", action="store_true")
    args = parser.parse_args(argv)
    rng = np.random.RandomState(args.seed)
    np.random.seed(args.seed)
    from .. import configs

    if args.dataset == "nuscenes":
        root = Path(args.root) / (configs.NUSCENES_DATASET_BASE["VERSION"]
                                  if args.full_density else "")
        write_nuscenes_tree(root, args.frames, rng=rng, full_density=args.full_density,
                            n_val=args.val_frames)
        if args.full_density:
            nuscenes_gt_database(root, configs.NUSCENES_DATASET_BASE, configs.CBGS_CLASS_NAMES,
                                 "nuscenes_infos_train_10sweeps_withvelo.pkl")
    else:
        write_waymo_tree(args.root, args.frames, rng=rng, full_density=args.full_density,
                         n_val=args.val_frames)
        if args.full_density:
            waymo_gt_database(args.root, configs.WAYMO_DATASET_BASE, configs.WAYMO_CLASS_NAMES)


if __name__ == "__main__":
    main()
