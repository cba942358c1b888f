"""Cache combined historical-traversal point clouds per train frame — the
port's own copy of ``modest_tpu/preprocessing/gather_historical_traversals.py``,
with its progress on stderr (no tqdm).

Reference: data_preprocessing/gather_historical_traversals.py — a standalone
version of the PP-score pose-alignment step that dumps, for each valid train
frame, the aligned multi-traversal clouds and the origin frame's transform.

Usage:
  python -m modest_tpu_torch.preprocessing.gather_historical_traversals \
      --data_root <kitti>/training --track_list <pkl> --idx_info <pkl> \
      --save_dir <dir> [--nusc]
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle

import numpy as np
from ..cli.common import progress
from ..pipeline.pp_score import TraversalIndex


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_root", required=True)
    parser.add_argument("--track_list", required=True)
    parser.add_argument("--idx_info", required=True)
    parser.add_argument("--save_dir", required=True)
    parser.add_argument("--trans_mat_dir", default=None)
    parser.add_argument("--nusc", action="store_true")
    parser.add_argument("--total_part", type=int, default=1)
    parser.add_argument("--part", type=int, default=0)
    args = parser.parse_args(argv)

    with open(args.track_list, "rb") as f:
        track_list = pickle.load(f)
    with open(args.idx_info, "rb") as f:
        valid_idx = pickle.load(f)
    os.makedirs(args.save_dir, exist_ok=True)
    if args.trans_mat_dir:
        os.makedirs(args.trans_mat_dir, exist_ok=True)

    index = TraversalIndex(args.data_root, track_list, valid_idx, nusc=args.nusc)
    idx_list = np.array(sorted(valid_idx))
    if args.total_part > 1:
        idx_list = np.array_split(idx_list, args.total_part)[args.part]

    for done, origin_idx in enumerate(idx_list, 1):
        origin_idx = int(origin_idx)
        out = osp.join(args.save_dir, f"{origin_idx:06d}.pkl")
        if not osp.exists(out):
            combined, trans_mat = index.combined_traversals(origin_idx)
            with open(out, "wb") as f:
                pickle.dump(combined, f)
            if args.trans_mat_dir:
                np.save(osp.join(args.trans_mat_dir, f"{origin_idx:06d}.npy"), trans_mat)
        progress(done, len(idx_list), "gather_historical_traversals")


if __name__ == "__main__":
    main()
