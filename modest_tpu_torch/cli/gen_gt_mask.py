"""CLI: rasterize label boxes into per-point labels (segmentation-style eval
aid) — port of ``modest_tpu/cli/gen_gt_mask.py`` (reference
generate_cluster_mask/gen_gt_mask.py). Host numpy. Writes
``save_dir/{idx:06d}.npy`` with 0 = background and 1..K = object id per
point; existing outputs are kept.

Usage:
  python -m modest_tpu_torch.cli.gen_gt_mask --data_root <kitti>/training \
      --idx_list <txt> --save_dir <dir> [--label_dir label_2]
"""
from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np

from ..pipeline.seed_labels import points_in_camera_box
from ..utils import kitti_io
from .common import progress


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_root", required=True)
    parser.add_argument("--idx_list", required=True)
    parser.add_argument("--save_dir", required=True)
    parser.add_argument("--label_dir", default="label_2")
    args = parser.parse_args(argv)

    with open(args.idx_list) as f:
        idx_list = [int(x) for x in f.readlines()]
    os.makedirs(args.save_dir, exist_ok=True)
    for done, idx in enumerate(idx_list, 1):
        out = osp.join(args.save_dir, f"{idx:06d}.npy")
        if not osp.exists(out):
            ptc = kitti_io.load_velo_scan(osp.join(args.data_root, "velodyne", f"{idx:06d}.bin"))
            calib = kitti_io.Calibration(osp.join(args.data_root, "calib", f"{idx:06d}.txt"))
            ptc_rect = calib.project_velo_to_rect(ptc[:, :3])
            label_path = osp.join(args.data_root, args.label_dir, f"{idx:06d}.txt")
            objs = kitti_io.read_label(label_path) if osp.exists(label_path) else []
            labels = np.zeros(len(ptc), np.int64)
            for i, obj in enumerate(objs):
                labels[points_in_camera_box(ptc_rect, obj)] = i + 1
            np.save(out, labels)
        progress(done, len(idx_list), "gen_gt_mask")


if __name__ == "__main__":
    main()
