"""CLI: seed box pkl → KITTI label_2 txt files (NMS + FOV filter) — port of
``modest_tpu/cli/generate_label_files.py`` (reference
generate_cluster_mask/gen_label_files.py).

Writes ``label_file_save_dst/{idx:06d}.txt`` for every frame of the index
list (sharded by ``total_part``/``part``). The BEV NMS runs on the card
unless ``device=cpu``.

Usage:
  python -m modest_tpu_torch.cli.generate_label_files data_root=/data/lyft/training \
      [device=cpu] [key=value ...]
"""
from __future__ import annotations

import os
import os.path as osp
import pickle

from ..pipeline.seed_labels import is_within_fov, objs2label, objs_nms
from ..utils import kitti_io
from ..utils.device import resolve_device
from .common import display_args, load_pipeline_config, make_parser, progress, shard_idx_list


def main(argv=None):
    args = make_parser(__doc__).parse_args(argv)
    cfg = load_pipeline_config("generate_label_files", args.overrides)
    display_args("kitti_label gen", cfg)
    device = resolve_device(cfg.get("device", "cuda"))

    with open(cfg.data_paths.idx_list) as f:
        idx_list = [int(x) for x in f.readlines()]
    idx_list = shard_idx_list(idx_list, cfg.total_part, cfg.part)
    os.makedirs(cfg.data_paths.label_file_save_dst, exist_ok=True)

    for done, idx in enumerate(idx_list, 1):
        idx = int(idx)
        with open(osp.join(cfg.data_paths.bbox_info_save_dst, f"{idx:06d}.pkl"), "rb") as f:
            objs = pickle.load(f)
        if cfg.nms.enable and len(objs) > 0:
            objs = objs_nms(objs, nms_threshold=cfg.nms.threshold, device=device)
        calib = kitti_io.Calibration(osp.join(cfg.calib_path, f"{idx:06d}.txt"))
        if cfg.fov_only:
            objs = [o for o in objs if is_within_fov(o, calib, cfg.image_shape)]
        with open(osp.join(cfg.data_paths.label_file_save_dst, f"{idx:06d}.txt"), "w") as f:
            f.write(objs2label(objs, calib))
        progress(done, len(idx_list), "generate_label_files")


if __name__ == "__main__":
    main()
