"""CLI: compute PP (persistence) scores for all training frames.

Port of ``modest_tpu/cli/pre_compute_pp_score.py``: the same metadata inputs
(track_list / valid_idx pickles), the same ``pp_score/{idx:06d}.npy``
outputs, idempotent skip and ``total_part``/``part`` sharding. Runs on the
card unless ``device=cpu``.

Usage:
  python -m modest_tpu_torch.cli.pre_compute_pp_score data_root=/data/lyft/training \
      [data_paths=nusc] [device=cpu] [key=value ...]
"""
from __future__ import annotations

import collections
import concurrent.futures as cf
import os
import os.path as osp
import pickle

import numpy as np

from ..pipeline.pp_score import (FrameCache, TraversalIndex, pp_score_for_frame,
                                 pp_score_for_frame_cached, remove_center)
from ..utils.device import StageTimer, resolve_device
from .common import display_args, load_pipeline_config, make_parser, progress, shard_idx_list


def main(argv=None, timer: StageTimer | None = None):
    """``timer``, when given, collects the per-stage times of every origin."""
    args = make_parser(__doc__).parse_args(argv)
    cfg = load_pipeline_config("pp_score", args.overrides)
    display_args("ephemerality", cfg)
    device = resolve_device(cfg.get("device", "cuda"))

    np.random.seed(cfg.seed)
    with open(cfg.data_paths.track_path, "rb") as f:
        track_list = pickle.load(f)
    with open(cfg.data_paths.idx_info, "rb") as f:
        valid_idx = pickle.load(f)
    os.makedirs(cfg.data_paths.pp_score_path, exist_ok=True)

    if cfg.data_paths.idx_list is not None and osp.exists(str(cfg.data_paths.idx_list)):
        with open(cfg.data_paths.idx_list) as f:
            idx_list = [int(x) for x in f.readlines()]
    else:
        idx_list = list(valid_idx)
    idx_list = shard_idx_list(idx_list, cfg.total_part, cfg.part)

    index = TraversalIndex(cfg.data_root, track_list, valid_idx, nusc=cfg.nusc)
    # raw frames stay on the device across origin frames; the noise ablation
    # perturbs the origin cloud and takes the combined-cloud path
    use_cache = cfg.add_random_noise <= 0

    def _load(gid):
        pts = index._velo(gid)
        return remove_center(pts) if cfg.nusc else pts

    cache = FrameCache(_load, device) if use_cache else None

    trans_dir = cfg.data_paths.load_save_precomputed_trans_mat
    if trans_dir is not None:
        os.makedirs(trans_dir, exist_ok=True)

    def process(origin_idx: int, out: str):
        if use_cache:
            H = pp_score_for_frame_cached(index, cache, origin_idx, radius=cfg.max_neighbor_dist,
                                          limit_traversals=cfg.limit_traversals, timer=timer)
        else:
            H = pp_score_for_frame(index, origin_idx, radius=cfg.max_neighbor_dist,
                                   limit_traversals=cfg.limit_traversals,
                                   add_random_noise=cfg.add_random_noise, device=device)
        np.save(out, H.astype(np.float32))

    # two origins in flight: one origin's host stages (file reads, pose math,
    # entropy) overlap the other's device work
    workers = int(cfg.get("pipeline_workers", 2)) if use_cache else 1
    pool = cf.ThreadPoolExecutor(workers) if workers > 1 else None
    futs: collections.deque = collections.deque()
    for done, origin_idx in enumerate(idx_list, 1):
        origin_idx = int(origin_idx)
        out = osp.join(cfg.data_paths.pp_score_path, f"{origin_idx:06d}.npy")
        progress(done, len(idx_list), "pp_score")
        if osp.exists(out) or osp.exists(out[:-4]):
            continue
        n_traversals = len(valid_idx[origin_idx][2])
        if n_traversals <= 1:
            raise ValueError(f"origin {origin_idx} has {n_traversals} traversal(s); PP needs 2+")
        if trans_dir is not None:
            _, trans_mat = index.combined_traversals(origin_idx)
            np.save(osp.join(trans_dir, f"{origin_idx:06d}.npy"), trans_mat)
        if cfg.skip_ephe:
            continue
        if pool is None:
            process(origin_idx, out)
        else:
            futs.append(pool.submit(process, origin_idx, out))
            while len(futs) > workers:
                futs.popleft().result()
    for f in futs:
        f.result()
    if pool is not None:
        pool.shutdown()


if __name__ == "__main__":
    main()
