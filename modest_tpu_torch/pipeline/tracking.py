"""Box tracking across frames — the port's own copy of
``modest_tpu/pipeline/tracking.py`` (reference generate_cluster_mask/utils/
tracking_utils.py — dormant there, provided here for capability parity).

Greedy BEV-IoU association of per-frame boxes into tracks; world-frame
alignment comes from the known per-frame poses (the reference additionally
ships an open3d FPFH/ICP global-registration path for pose-less data, which
is out of scope for this pipeline — poses are always available in the
MODEST data contract).
"""
from __future__ import annotations

import numpy as np

from ..utils import box_np
from ..utils.native import bev_iou
from ..utils.pose import transform_points


class Track:
    """One tracked object: per-frame boxes + bookkeeping."""

    def __init__(self, track_id: int, frame: int, box7: np.ndarray, score: float = 0.0):
        self.track_id = track_id
        self.frames = [frame]
        self.boxes = [np.asarray(box7, np.float64)]
        self.scores = [score]
        self.missed = 0

    @property
    def last_box(self) -> np.ndarray:
        return self.boxes[-1]

    def extend(self, frame: int, box7, score: float = 0.0):
        self.frames.append(frame)
        self.boxes.append(np.asarray(box7, np.float64))
        self.scores.append(score)
        self.missed = 0

    def __len__(self):
        return len(self.frames)


def transform_boxes(boxes7: np.ndarray, T: np.ndarray) -> np.ndarray:
    """Rigid-transform lidar boxes (rotation assumed yaw-only, as in the
    multi-traversal alignment chain)."""
    out = np.array(boxes7, copy=True)
    if len(out) == 0:
        return out
    out[:, :3] = transform_points(out[:, :3], T)
    yaw = np.arctan2(T[1, 0], T[0, 0])
    out[:, 6] = out[:, 6] + yaw
    return out


def associate_boxes_to_tracks(tracks: list, boxes7: np.ndarray, frame: int,
                              scores=None, iou_threshold: float = 0.1,
                              max_missed: int = 3, next_id: int = 0):
    """Greedy best-IoU-first assignment (reference
    tracking_utils.associate_bbox_to_track:186-243 semantics).

    Returns (tracks, next_id); unmatched boxes start new tracks, tracks
    missing > max_missed frames are frozen (left in the list, not extended).
    """
    boxes7 = np.asarray(boxes7, np.float64).reshape(-1, 7)
    scores = np.zeros(len(boxes7)) if scores is None else np.asarray(scores)
    active = [t for t in tracks if t.missed <= max_missed]
    if len(active) and len(boxes7):
        last = np.stack([t.last_box[:7] for t in active])
        iou = bev_iou(last, boxes7)  # (T, N)
        pairs = []
        flat = np.argsort(-iou, axis=None)
        used_t, used_b = set(), set()
        for f in flat:
            ti, bi = np.unravel_index(f, iou.shape)
            if iou[ti, bi] <= iou_threshold:
                break
            if ti in used_t or bi in used_b:
                continue
            used_t.add(int(ti))
            used_b.add(int(bi))
            pairs.append((int(ti), int(bi)))
        for ti, bi in pairs:
            active[ti].extend(frame, boxes7[bi], float(scores[bi]))
        for t_idx, t in enumerate(active):
            if t_idx not in used_t:
                t.missed += 1
        for bi in range(len(boxes7)):
            if bi not in used_b:
                tracks.append(Track(next_id, frame, boxes7[bi], float(scores[bi])))
                next_id += 1
    else:
        for t in active:
            t.missed += 1
        for bi in range(len(boxes7)):
            tracks.append(Track(next_id, frame, boxes7[bi], float(scores[bi])))
            next_id += 1
    return tracks, next_id


def build_tracks(frame_boxes: dict, poses: dict | None = None,
                 iou_threshold: float = 0.1, max_missed: int = 3) -> list:
    """Track boxes across an ordered {frame: (N,7) boxes} dict; optional
    {frame: 4x4 pose} maps everything into a common world frame first."""
    tracks: list = []
    next_id = 0
    for frame in sorted(frame_boxes):
        boxes = np.asarray(frame_boxes[frame], np.float64).reshape(-1, 7)
        if poses is not None:
            boxes = transform_boxes(boxes, poses[frame])
        tracks, next_id = associate_boxes_to_tracks(
            tracks, boxes, frame, iou_threshold=iou_threshold,
            max_missed=max_missed, next_id=next_id,
        )
    return tracks


def interpolate_track(track: Track, frame: int) -> np.ndarray:
    """Linear interpolation of a track's box at an intermediate frame."""
    frames = np.asarray(track.frames)
    boxes = np.stack(track.boxes)
    if frame <= frames[0]:
        return boxes[0]
    if frame >= frames[-1]:
        return boxes[-1]
    hi = int(np.searchsorted(frames, frame))
    lo = hi - 1
    t = (frame - frames[lo]) / max(frames[hi] - frames[lo], 1)
    out = boxes[lo] * (1 - t) + boxes[hi] * t
    # angles interpolate on the circle
    d = box_np.limit_period(boxes[hi, 6] - boxes[lo, 6], 0.5, 2 * np.pi)
    out[6] = boxes[lo, 6] + t * d
    return out
