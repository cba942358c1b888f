"""Synthetic lidar frames and an on-disk multi-traversal dataset for driving
the label-free pipeline (PP score → seed masks and boxes) without real data.

``synth_frame`` is ``bench_pipeline.py``'s full-size recipe: 60000 ground
points over 90 m × 80 m, 12 car-sized clusters of 800 points and a 20000-point
wall, 89600 points per frame. ``write_dataset`` lays frames out in the KITTI
multi-traversal format the pipeline CLIs read (``velodyne``, ``oxts``,
``l2e``, ``calib``, and the track list / valid-index pickles and the index
list under ``meta_data/lyft`` with the ``fw70_2m`` names), so
``work_dir=<root> data_root=<root>/training`` runs both CLIs on it.
"""
from __future__ import annotations

import os
import pickle
from pathlib import Path

import numpy as np

from ..utils.kitti_io import save_velo_scan

P2 = np.array([[700.0, 0, 600, 0], [0, 700.0, 200, 0], [0, 0, 1.0, 0]])
V2C = np.array([[0.0, -1, 0, 0], [0, 0, -1, 0], [1.0, 0, 0, 0]])


def synth_frame(rng, n_ground=60000, n_objects=12, n_wall=20000) -> np.ndarray:
    """(n_ground + 800·n_objects + n_wall, 3) float32 velodyne points."""
    pts = [np.stack([rng.uniform(0, 90, n_ground), rng.uniform(-40, 40, n_ground),
                     rng.normal(-1.8, 0.03, n_ground)], 1)]
    for _ in range(n_objects):
        c = rng.uniform([5, -30, -1.6], [70, 30, -1.2])
        pts.append(c + rng.uniform(-1, 1, (800, 3)) * [2.2, 1.0, 0.75])
    pts.append(np.stack([rng.uniform(0, 90, n_wall), np.full(n_wall, -35.0) + rng.randn(n_wall),
                         rng.uniform(-1.8, 2, n_wall)], 1))
    return np.concatenate(pts).astype(np.float32)


def write_calib(path):
    with open(path, "w") as f:
        for key, mat in (("P2", P2), ("P3", P2), ("R0_rect", np.eye(3)), ("Tr_velo_to_cam", V2C)):
            f.write(f"{key}: " + " ".join(map(str, mat.reshape(-1))) + "\n")


def write_dataset(root, frames, track_list, valid_idx, poses=None) -> tuple[Path, Path]:
    """Write ``frames`` ({global id: (N, 3+) points}) as a multi-traversal
    dataset under ``root``. ``track_list``: global ids per sequence;
    ``valid_idx``: {origin id: (origin seq, origin frame, [(seq, frame
    indices), ...])}; ``poses``: {global id: oxts line "x y z rx ry rz"},
    identity where missing. The index list holds the origin ids. Returns
    (root, data_root)."""
    root = Path(root)
    data_root = root / "training"
    for sub in ("velodyne", "oxts", "l2e", "calib"):
        os.makedirs(data_root / sub, exist_ok=True)
    meta = root / "meta_data" / "lyft"
    os.makedirs(meta, exist_ok=True)
    for gid, pts in frames.items():
        pts = np.asarray(pts, np.float32)
        scan = np.concatenate([pts[:, :3], np.zeros((len(pts), 1), np.float32)], 1)
        save_velo_scan(data_root / "velodyne" / f"{gid:06d}.bin", scan)
        (data_root / "oxts" / f"{gid:06d}.txt").write_text((poses or {}).get(gid, "0 0 0 0 0 0")
                                                           + "\n")
        np.save(data_root / "l2e" / f"{gid:06d}.npy", np.eye(4, dtype=np.float32))
        write_calib(data_root / "calib" / f"{gid:06d}.txt")
    with open(meta / "fw70_2m_train_track_list.pkl", "wb") as f:
        pickle.dump(track_list, f)
    with open(meta / "fw70_2m_valid_train_idx_info.pkl", "wb") as f:
        pickle.dump(valid_idx, f)
    (meta / "fw70_2m_train_idx.txt").write_text("".join(f"{i}\n" for i in valid_idx))
    return root, data_root


def write_synth_dataset(root, *, traversals=5, frames_per_traversal=8, origins=4,
                        seed=0, **frame_kw) -> tuple[Path, Path]:
    """A full-size dataset: ``traversals`` past drives of
    ``frames_per_traversal`` ``synth_frame`` scans each (sequences 0..T-1)
    and one current drive of ``origins`` scans (sequence T), each origin
    looking at every past drive's frames. Each scan drops up to 255 of its
    last (wall) points, so sizes vary as real scans' do; poses are small
    random shifts and yaws; all from ``seed``."""
    rng = np.random.RandomState(seed)
    frames, poses, track_list = {}, {}, []
    gid = 0
    for _ in range(traversals + 1):
        seq = []
        n = origins if len(track_list) == traversals else frames_per_traversal
        for _ in range(n):
            # scans differ in size: drop up to 255 of the last (wall) points
            pts = synth_frame(rng, **frame_kw)
            frames[gid] = pts[: len(pts) - rng.randint(0, 256)]
            dx, dy, yaw = rng.uniform(-0.5, 0.5), rng.uniform(-0.5, 0.5), rng.uniform(-0.02, 0.02)
            poses[gid] = f"{dx} {dy} 0 0 0 {yaw}"
            seq.append(gid)
            gid += 1
        track_list.append(seq)
    neighbors = [(s, list(range(frames_per_traversal))) for s in range(traversals)]
    valid_idx = {g: (traversals, j, neighbors) for j, g in enumerate(track_list[traversals])}
    return write_dataset(root, frames, track_list, valid_idx, poses)
