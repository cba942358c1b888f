"""Geo train/test split + multi-traversal index — the port's own copy of
``modest_tpu/preprocessing/split_traintest.py`` (numpy only).

Reference: data_preprocessing/lyft/split_traintest.py (Lyft, map-y cutoff
1700, dis_choice 2..70 step 2, only_forward) and
data_preprocessing/nuscenes/split_traintest.py (x cutoff 1500,
linspace(0, 30, 16)). The traversal index maps each valid train frame to the
other traversals that pass within ``max_allow_dist`` of it, with frames
sampled at increasing along-track distances.

Usage:
  python -m modest_tpu_torch.preprocessing.split_traintest --data_root <kitti root> \
      --track_list_file <tracks.pkl> [--dataset lyft|nuscenes]
"""
from __future__ import annotations

import argparse
import os.path as osp
import pickle

import numpy as np

from ..utils.pose import load_oxts_pose


def load_track_poses(data_root, track_list):
    oxts_path = osp.join(str(data_root), "training", "oxts")
    poses = []
    for seq in track_list:
        poses.append([load_oxts_pose(osp.join(oxts_path, f"{i:06d}.txt")) for i in seq])
    return poses


def geo_split(track_list, poses, cutoff: float, axis: int, train_below: bool = True):
    """Sequences entirely on one side of the cutoff → train; the other → test.

    Reference keeps only fully-one-side sequences (lyft :38-41): straddling
    sequences are dropped from both splits.
    """
    train_track, test_track = [], []
    for seq, seq_poses in zip(track_list, poses):
        locs = np.array([p[axis, 3] for p in seq_poses])
        below = locs < cutoff
        if below.all():
            (train_track if train_below else test_track).append(seq)
        elif (~below).all():
            (test_track if train_below else train_track).append(seq)
    return train_track, test_track


def build_traversal_index(track_list, poses, max_allow_dist: float = 3.0,
                          dis_choice=None, only_forward: bool = True):
    """{origin_global_idx: (seq_id, frame, [(other_seq, frame_indices), ...])}.

    Mirrors the reference's selection exactly (:57-114): for each origin
    frame, each other traversal contributes its closest frame plus frames at
    increasing distances (ahead if heading-aligned, behind otherwise); a
    traversal qualifies only if ALL distance slots fill; the origin frame is
    kept if ≥ 2 traversals qualify.
    """
    if dis_choice is None:
        dis_choice = np.arange(2, 71, 2)
    loc_cache = [np.array([p[:2, 3] for p in seq_poses]) for seq_poses in poses]

    valid_idx = {}
    for origin_seq_id, origin_seq in enumerate(track_list):
        for origin_frame in range(len(origin_seq)):
            origin_pose = poses[origin_seq_id][origin_frame]
            origin_idx = track_list[origin_seq_id][origin_frame]
            valid_seq = []
            for seq_id in range(len(track_list)):
                if seq_id == origin_seq_id:
                    continue
                distance = np.linalg.norm(loc_cache[seq_id] - origin_pose[:2, 3], axis=1)
                min_i = int(np.argmin(distance))
                if distance[min_i] > max_allow_dist:
                    continue
                indices = [min_i]
                if only_forward:
                    forward = origin_pose[0, :3] @ poses[seq_id][min_i][0, :3] > 0
                    for dis in dis_choice:
                        temp = np.where(distance > dis)[0]
                        cand = temp[temp > min_i] if forward else temp[temp < min_i]
                        if len(cand) == 0:
                            break
                        indices.append(int(cand.min() if forward else cand.max()))
                    if len(indices) < len(dis_choice) + 1:
                        continue
                else:
                    ok = True
                    for dis in dis_choice:
                        temp = np.where(distance > dis)[0]
                        behind = temp[temp < min_i]
                        ahead = temp[temp > min_i]
                        if len(behind) == 0:
                            ok = False
                            break
                        indices.append(int(behind.max()))
                        if len(ahead) == 0:
                            ok = False
                            break
                        indices.append(int(ahead.min()))
                    if not ok or len(indices) < 2 * len(dis_choice) + 1:
                        continue
                valid_seq.append((seq_id, indices))
            if len(valid_seq) > 1:
                valid_idx[origin_idx] = (origin_seq_id, origin_frame, valid_seq)
    return valid_idx


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--track_list_file", required=True)
    parser.add_argument("--data_root", required=True)
    parser.add_argument("--save_root", default="./meta_data/")
    parser.add_argument("--dataset", choices=["lyft", "nuscenes"], default="lyft")
    parser.add_argument("--max_allow_dist", type=float, default=3.0)
    parser.add_argument("--disable_only_forward", dest="only_forward", action="store_false")
    parser.add_argument("--prefix", type=str, default=None)
    parser.add_argument("--cutoff", type=float, default=None)
    args = parser.parse_args(argv)

    if args.dataset == "lyft":
        cutoff = args.cutoff if args.cutoff is not None else 1700.0
        axis = 1  # map y
        dis_choice = np.arange(2, 71, 2)
        prefix = args.prefix or "fw70_2m_"
    else:
        cutoff = args.cutoff if args.cutoff is not None else 1500.0
        axis = 0  # map x
        dis_choice = np.linspace(0, 30, 16)
        prefix = args.prefix or ""

    with open(args.track_list_file, "rb") as f:
        track_list = pickle.load(f)
    poses_all = load_track_poses(args.data_root, track_list)
    train_track, test_track = geo_split(track_list, poses_all, cutoff, axis)
    print(f"train sequences: {len(train_track)}, test sequences: {len(test_track)}")

    train_poses = load_track_poses(args.data_root, train_track)
    valid_idx = build_traversal_index(
        train_track, train_poses, args.max_allow_dist, dis_choice, args.only_forward
    )
    print(f"#train frames with >=2 traversals: {len(valid_idx)}")

    with open(osp.join(args.save_root, f"{prefix}train_track_list.pkl"), "wb") as f:
        pickle.dump(train_track, f)
    with open(osp.join(args.save_root, f"{prefix}valid_train_idx_info.pkl"), "wb") as f:
        pickle.dump(valid_idx, f)
    with open(osp.join(args.save_root, f"{prefix}train_idx.txt"), "w") as f:
        f.write("\n".join(f"{x:06d}" for x in valid_idx))
    full_test = [i for seq in test_track for i in seq]
    with open(osp.join(args.save_root, f"{prefix}full_test_idx.txt"), "w") as f:
        f.write("\n".join(f"{x:06d}" for x in full_test))


if __name__ == "__main__":
    main()
