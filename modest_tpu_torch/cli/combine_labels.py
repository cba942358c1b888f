"""CLI: fuse detector results with seed boxes into the next round's labels —
port of ``modest_tpu/cli/combine_labels.py`` (reference
generate_cluster_mask/combine_labels.py).

Reads the detector's ``result.pkl`` (a list of per-frame KITTI annos),
PP-filters the detections, unions them with the area-scored seed boxes,
runs a score-ranked BEV NMS (on the card unless ``device=cpu``) and writes
KITTI label txts. Sharding (``total_part``/``part``) splits the result's
positions, so every part pairs its frames with its own detections.

Usage:
  python -m modest_tpu_torch.cli.combine_labels data_root=... det_result_path=... \
      save_path=... [device=cpu] [key=value ...]
"""
from __future__ import annotations

import os
import os.path as osp
import pickle

import numpy as np

from ..pipeline.seed_labels import combine_labels_for_frame, objs2label
from ..utils import kitti_io
from ..utils.device import resolve_device
from .common import (display_args, eprint, load_pipeline_config, make_parser, progress,
                     shard_idx_list)


def main(argv=None):
    args = make_parser(__doc__).parse_args(argv)
    cfg = load_pipeline_config("combine_labels", args.overrides)
    display_args("combine_labels", cfg)
    device = resolve_device(cfg.get("device", "cuda"))

    with open(cfg.det_result_path, "rb") as f:
        det_bboxes = pickle.load(f)
    positions = np.arange(len(det_bboxes))
    if cfg.total_part > 1:
        positions = shard_idx_list(positions, cfg.total_part, cfg.part)
    os.makedirs(cfg.save_path, exist_ok=True)
    if cfg.data_paths.bbox_info_save_dst is None:
        eprint("Warning: not adding generated bboxes")

    for done, pos in enumerate(positions, 1):
        det_bbox = det_bboxes[int(pos)]
        idx = int(det_bbox["frame_id"])
        if cfg.data_paths.bbox_info_save_dst is not None:
            with open(osp.join(cfg.data_paths.bbox_info_save_dst, f"{idx:06d}.pkl"), "rb") as f:
                gen_objs = pickle.load(f)
        else:
            gen_objs = []
        calib = kitti_io.Calibration(osp.join(cfg.calib_path, f"{idx:06d}.txt"))
        ptc = kitti_io.load_velo_scan(osp.join(cfg.ptc_path, f"{idx:06d}.bin"))
        ptc_rect = calib.project_velo_to_rect(ptc[:, :3])
        pp_score = np.load(osp.join(cfg.data_paths.pp_score_path, f"{idx:06d}.npy"))

        objs = combine_labels_for_frame(det_bbox, gen_objs, ptc_rect, pp_score, calib, cfg,
                                        device=device)
        with open(osp.join(cfg.save_path, f"{idx:06d}.txt"), "w") as f:
            f.write(objs2label(objs, calib, with_score=cfg.with_score))
        progress(done, len(positions), "combine_labels")


if __name__ == "__main__":
    main()
