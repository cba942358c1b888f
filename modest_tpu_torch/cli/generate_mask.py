"""CLI: PP-gated clustering → per-point seed masks + seed bounding boxes.

Port of ``modest_tpu/cli/generate_mask.py``: writes
``seg_save_dst/{idx:06d}.npy`` (per-point cluster labels, 0 = background)
and ``bbox_info_save_dst/{idx:06d}.pkl`` (list of seed box objects), plus a
``configs.yaml`` snapshot beside each output dir (written as JSON, which a
YAML parser reads). Frames go through the device in groups of
``device_batch_frames`` (default 4), with ``pipeline_workers`` (default 3)
groups in flight. Runs on the card unless ``device=cpu``.

Usage:
  python -m modest_tpu_torch.cli.generate_mask data_root=/data/lyft/training [device=cpu] \
      [key=value ...]
"""
from __future__ import annotations

import collections
import concurrent.futures as cf
import os
import os.path as osp
import pickle

import numpy as np

from ..pipeline.seed_labels import generate_mask_for_frame, generate_masks_for_frames
from ..utils import kitti_io
from ..utils.config import save_config
from ..utils.device import StageTimer, resolve_device
from .common import (display_args, load_pipeline_config, make_parser, progress,
                     shard_idx_list)


def _save_config(cfg, out_dir):
    path = osp.join(out_dir, "configs.yaml")
    if not osp.exists(path):
        save_config(cfg, path)


def main(argv=None, timer: StageTimer | None = None):
    """``timer``, when given, collects the per-stage times of every group."""
    args = make_parser(__doc__).parse_args(argv)
    cfg = load_pipeline_config("generate_mask", args.overrides)
    display_args("clustering", cfg)
    device = resolve_device(cfg.get("device", "cuda"))

    with open(cfg.data_paths.idx_list) as f:
        idx_list = [int(x) for x in f.readlines()]
    idx_list = shard_idx_list(idx_list, cfg.total_part, cfg.part)

    os.makedirs(cfg.data_paths.seg_save_dst, exist_ok=True)
    _save_config(cfg, cfg.data_paths.seg_save_dst)
    bbox_dst = cfg.data_paths.get("bbox_info_save_dst", None)
    if bbox_dst is not None:
        os.makedirs(bbox_dst, exist_ok=True)
        _save_config(cfg, bbox_dst)

    def _outputs(idx: int):
        seg_out = osp.join(cfg.data_paths.seg_save_dst, f"{idx:06d}.npy")
        bbox_out = osp.join(bbox_dst, f"{idx:06d}.pkl") if bbox_dst else None
        return seg_out, bbox_out

    def _done(idx: int) -> bool:
        seg_out, bbox_out = _outputs(idx)
        return osp.exists(seg_out) and (bbox_out is None or osp.exists(bbox_out))

    def _load(idx: int):
        ptc = kitti_io.load_velo_scan(osp.join(cfg.ptc_path, f"{idx:06d}.bin"))
        pp_score = np.load(osp.join(cfg.data_paths.pp_score_path, f"{idx:06d}.npy"))
        calib = kitti_io.Calibration(osp.join(cfg.calib_path, f"{idx:06d}.txt"))
        return ptc, pp_score, calib

    def _save(idx: int, labels, objs):
        seg_out, bbox_out = _outputs(idx)
        if bbox_out is not None:
            with open(bbox_out, "wb") as f:
                pickle.dump(objs, f)
        np.save(seg_out, labels)

    def process(idx: int):
        if _done(idx):
            return
        ptc, pp_score, calib = _load(idx)
        _save(idx, *generate_mask_for_frame(ptc, pp_score, calib, cfg, device, timer))

    def process_group(idxs):
        todo = [i for i in idxs if not _done(i)]
        if not todo:
            return
        loaded = [_load(i) for i in todo]
        results = generate_masks_for_frames([(ptc, pp) for ptc, pp, _ in loaded],
                                            [c for _, _, c in loaded], cfg, device, timer)
        for idx, (labels, objs) in zip(todo, results):
            _save(idx, labels, objs)

    # frames go through the device in groups (one batched clustering pass
    # and one box-fit scan per group), and `pipeline_workers` groups stay in
    # flight so one group's host stages (file reads, plane RANSAC, filters)
    # overlap another's device work. workers=1 + group=1 is a sequential loop.
    workers = int(cfg.get("pipeline_workers", 3))
    group = int(cfg.get("device_batch_frames", 4))
    if workers <= 1 and group <= 1:
        for done, idx in enumerate(idx_list, 1):
            process(int(idx))
            progress(done, len(idx_list), "generate_mask")
        return
    groups = [[int(i) for i in idx_list[s: s + group]]
              for s in range(0, len(idx_list), max(group, 1))]
    done = 0
    with cf.ThreadPoolExecutor(max(workers, 1)) as pool:
        pending = collections.deque()
        for g in groups:
            pending.append((len(g), pool.submit(process_group, g)))
            while pending and (len(pending) >= max(workers, 1) * 2 or g is groups[-1]):
                cnt, fut = pending.popleft()
                fut.result()
                done += cnt
                progress(done, len(idx_list), "generate_mask")


if __name__ == "__main__":
    main()
