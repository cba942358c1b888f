"""Per-frame ground-plane files for gt-sampling augmentation — the port's
own copy of ``modest_tpu/preprocessing/ransac_planes.py`` (numpy only).

Reference: data_preprocessing/RANSAC.py — RANSAC plane fit in RECT camera
coords over a road-height band, written as KITTI planes/*.txt. Uses the
vectorized multi-hypothesis RANSAC from pipeline/ground_plane.

Usage:
  python -m modest_tpu_torch.preprocessing.ransac_planes --calib_dir ... \
      --lidar_dir ... --planes_dir ... [--min_h 1.5] [--max_h 2]
"""
from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np

from ..pipeline.ground_plane import _ransac_plane
from ..utils import kitti_io


def plane_for_frame(pc_rect: np.ndarray, min_h=1.5, max_h=2.0, seed=0):
    """(4,) plane [a b c d] in rect coords, unit normal facing up (-y)."""
    valid = (
        (pc_rect[:, 1] > min_h) & (pc_rect[:, 1] < max_h)
        & (pc_rect[:, 2] > -10) & (pc_rect[:, 2] < 70)
        & (pc_rect[:, 0] > -20) & (pc_rect[:, 0] < 20)
    )
    pts = pc_rect[valid]
    if len(pts) < 5:
        return np.array([0.0, -1.0, 0.0, 1.65])
    z = pts[:, 1]  # fit y = a·x + b·z + h
    thr = max(np.median(np.abs(z - np.median(z))), 1e-4)
    rng = np.random.RandomState(seed)
    a, b, h = _ransac_plane(pts[:, [0, 2]], z, 100, thr, rng)
    w = np.array([a, -1.0, b])
    norm = np.linalg.norm(w)
    return np.array([w[0] / norm, w[1] / norm, w[2] / norm, h / norm])


def extract_ransac(calib_dir, lidar_dir, planes_dir, min_h=1.5, max_h=2.0, split_file=None):
    if split_file is not None:
        with open(split_file) as f:
            idx_list = sorted(x.strip() for x in f if len(x) > 1)
    else:
        idx_list = sorted(x[:-4] for x in os.listdir(lidar_dir) if x.endswith(".bin"))
    os.makedirs(planes_dir, exist_ok=True)
    for data_idx in idx_list:
        calib = kitti_io.Calibration(osp.join(calib_dir, f"{data_idx}.txt"))
        pc = kitti_io.load_velo_scan(osp.join(lidar_dir, f"{data_idx}.bin"))
        pc_rect = calib.project_velo_to_rect(pc[:, :3])
        plane = plane_for_frame(pc_rect, min_h, max_h)
        with open(osp.join(planes_dir, f"{data_idx}.txt"), "w") as f:
            f.write("# Plane\nWidth 4\nHeight 1\n")
            f.write("{:e} {:e} {:e} {:e}".format(*plane))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--calib_dir", required=True)
    parser.add_argument("--lidar_dir", required=True)
    parser.add_argument("--planes_dir", required=True)
    parser.add_argument("--min_h", type=float, default=1.5)
    parser.add_argument("--max_h", type=float, default=2.0)
    parser.add_argument("--split_file", type=str, default=None)
    args = parser.parse_args(argv)
    extract_ransac(args.calib_dir, args.lidar_dir, args.planes_dir,
                   args.min_h, args.max_h, args.split_file)


if __name__ == "__main__":
    main()
