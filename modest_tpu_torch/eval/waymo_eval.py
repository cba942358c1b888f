"""SDK-free Waymo detection metrics (AP / APH, LEVEL_1 / LEVEL_2) — port of
``modest_tpu/eval/waymo_eval.py``.

Reimplements the semantics the reference binds through TensorFlow +
waymo_open_dataset (downstream/OpenPCDet/pcdet/datasets/waymo/waymo_eval.py
OpenPCDetWaymoDetectionMetricsEstimator, config at :85-107):

  * breakdown by OBJECT_TYPE, difficulty levels 1 and 2;
  * Hungarian matching at 3D IoU (0.7 vehicle / 0.5 pedestrian, sign,
    cyclist) per score cutoff (0.00 … 0.99 step 0.01, plus 1.0);
  * difficulty assignment where the labels carry none: > 5 points in
    box → LEVEL_1, otherwise LEVEL_2; zero-point boxes dropped
    (waymo_eval.py:43-50);
  * distance mask ‖xy‖ < thresh + 0.5 on both sides (:168-175);
  * APH: each TP weighted by heading accuracy
    1 − |wrap(θ_pred − θ_gt)| / π (official heading-accuracy weighting);
  * AP = Σ (r_i − r_{i−1}) · p_i over the cutoff-swept p/r points after
    the monotone precision envelope — the standard step integration; the
    official C++ additionally caps recall jumps at a 0.05 delta, which
    only differs on very sparse curves (101 cutoffs here).

LEVEL_1 scoring ignores LEVEL_2 ground truths entirely: a detection
matched to one is neither TP nor FP, an unmatched one is not FN.
LEVEL_2 scores against all ground truths.

No TensorFlow, no SDK: numpy + scipy Hungarian + the host library's rotated
BEV overlap (``utils/native.py``; ``ops/iou3d.py`` where it cannot be built).
"""
from __future__ import annotations

import numpy as np

# official OD-challenge thresholds (waymo_eval.py config: iou_thresholds
# indexed by type id [unknown, vehicle, pedestrian, sign, cyclist])
DEFAULT_IOU_THRESH = {
    "vehicle": 0.7, "car": 0.7,
    "pedestrian": 0.5, "sign": 0.5, "cyclist": 0.5,
}
SCORE_CUTOFFS = np.concatenate([np.arange(0, 100) * 0.01, [1.0]])


def _wrap_angle(a):
    return np.mod(a + np.pi, 2 * np.pi) - np.pi


def heading_accuracy(h_pred, h_gt):
    return np.maximum(0.0, 1.0 - np.abs(_wrap_angle(h_pred - h_gt)) / np.pi)


def _iou3d_np(boxes_a, boxes_b):
    """3D IoU, z-center boxes: the host library's BEV overlap
    (``utils/native.py::bev_overlap``, ``ops/iou3d.py`` on CPU tensors where
    the library cannot be built) and numpy z-extents."""
    if len(boxes_a) == 0 or len(boxes_b) == 0:
        return np.zeros((len(boxes_a), len(boxes_b)))
    from ..utils import native

    a = np.asarray(boxes_a, np.float64)[:, :7]
    b = np.asarray(boxes_b, np.float64)[:, :7]
    ov_bev = np.asarray(native.bev_overlap(a, b), np.float64)
    a_max, a_min = (a[:, 2] + a[:, 5] / 2)[:, None], (a[:, 2] - a[:, 5] / 2)[:, None]
    b_max, b_min = (b[:, 2] + b[:, 5] / 2)[None, :], (b[:, 2] - b[:, 5] / 2)[None, :]
    ov_h = np.clip(np.minimum(a_max, b_max) - np.maximum(a_min, b_min), 0, None)
    ov3d = ov_bev * ov_h
    vol_a = (a[:, 3] * a[:, 4] * a[:, 5])[:, None]
    vol_b = (b[:, 3] * b[:, 4] * b[:, 5])[None, :]
    return ov3d / np.maximum(vol_a + vol_b - ov3d, 1e-6)


def _assign(iou, thr):
    """Hungarian assignment restricted to pairs with IoU ≥ thr.

    Returns (pred_idx, gt_idx) arrays of accepted matches."""
    if iou.size == 0:
        return np.zeros(0, int), np.zeros(0, int)
    from scipy.optimize import linear_sum_assignment

    gated = np.where(iou >= thr, iou, 0.0)
    rows, cols = linear_sum_assignment(-gated)
    ok = iou[rows, cols] >= thr
    return rows[ok], cols[ok]


def _frame_stats(pred_boxes, pred_scores, gt_boxes, gt_level, thr,
                 needed_ks=None):
    """Per top-k prediction prefix: (tp, w_sum) per level + FP bookkeeping.

    Predictions are pre-sorted by score descending; returns a dict keyed by
    k with stats at 'only the top-k predictions kept'. LEVEL_1 ignores
    level-2 gts (matched: excluded from both TP and FP; unmatched gts of
    the other level never count as FN by construction of the per-level gt
    counts). `needed_ks` restricts the Hungarian solves to the prefix sizes
    the cutoff sweep will actually read (≤ |SCORE_CUTOFFS| distinct values
    instead of one solve per detection).
    """
    n = len(pred_boxes)
    iou = _iou3d_np(pred_boxes, gt_boxes)
    ks = sorted(set(needed_ks)) if needed_ks is not None else range(n + 1)
    stats = {}
    for k in ks:
        pi, gi = _assign(iou[:k], thr)
        row = {}
        for level in (1, 2):
            if level == 1:
                ok = gt_level[gi] == 1  # matches to L2 gts are ignored
                ignored_preds = int((gt_level[gi] == 2).sum())
            else:
                ok = np.ones(len(gi), bool)
                ignored_preds = 0
            tp = int(ok.sum())
            fp = k - len(gi) + (len(gi) - tp - ignored_preds)
            w = float(heading_accuracy(pred_boxes[pi[ok], 6],
                                       gt_boxes[gi[ok], 6]).sum())
            row[level] = (tp, fp, w)
        stats[k] = row
    return stats


def _ap_from_pr(precision, recall):
    """Monotone-envelope step integration over cutoff-swept p/r points."""
    order = np.argsort(recall, kind="stable")
    r = np.asarray(recall)[order]
    p = np.asarray(precision)[order]
    # envelope: precision non-increasing as recall grows
    p = np.maximum.accumulate(p[::-1])[::-1]
    r_prev = np.concatenate([[0.0], r[:-1]])
    return float(np.sum((r - r_prev) * p))


def waymo_detection_metrics(det_annos, gt_annos, class_names,
                            distance_thresh=100.0, iou_thresholds=None):
    """Waymo OD AP/APH per class and level.

    det_annos[i]: {"name": (N,), "score": (N,), "boxes_lidar": (N, 7+)}
    gt_annos[i]: {"name": (M,), "gt_boxes_lidar": (M, 7+),
                  "num_points_in_gt": (M,), optional "difficulty": (M,)}
    Box layout: [x, y, z_center, dx, dy, dz, heading].

    Returns a dict keyed like the reference's ap_dict
    (OBJECT_TYPE_TYPE_VEHICLE_LEVEL_1/AP, .../APH, ...).
    """
    assert len(det_annos) == len(gt_annos), (len(det_annos), len(gt_annos))
    iou_thresholds = iou_thresholds or DEFAULT_IOU_THRESH
    results = {}
    for cls in class_names:
        thr = iou_thresholds.get(cls.lower(), 0.5)
        num_gt = {1: 0, 2: 0}
        # per-frame prefix stats, then swept over the shared cutoffs
        frame_stats, frame_scores = [], []
        for det, gt in zip(det_annos, gt_annos):
            gname = np.asarray(gt["name"]).reshape(-1)
            gmask = gname == cls
            gboxes = np.asarray(gt["gt_boxes_lidar"], np.float64)
            gboxes = gboxes.reshape(-1, gboxes.shape[-1] if gboxes.ndim == 2 else 7)[gmask]
            npts = (np.asarray(gt["num_points_in_gt"]).reshape(-1)[gmask]
                    if "num_points_in_gt" in gt else np.full(int(gmask.sum()), 6))
            level = (np.asarray(gt["difficulty"]).reshape(-1)[gmask]
                     if "difficulty" in gt else np.zeros(int(gmask.sum())))
            level = level.astype(int).copy()
            level[(level == 0) & (npts > 5)] = 1
            level[(level == 0) & (npts <= 5)] = 2
            keep = npts > 0
            gboxes, level = gboxes[keep], level[keep]
            dmask = np.linalg.norm(gboxes[:, :2], axis=1) < distance_thresh + 0.5
            gboxes, level = gboxes[dmask], level[dmask]
            num_gt[1] += int((level == 1).sum())
            num_gt[2] += len(level)  # L2 scores against all gts

            dname = np.asarray(det["name"]).reshape(-1)
            dmask_c = dname == cls
            dboxes = np.asarray(det["boxes_lidar"], np.float64)
            dboxes = dboxes.reshape(-1, dboxes.shape[-1] if dboxes.ndim == 2 else 7)[dmask_c]
            dscores = np.asarray(det["score"], np.float64).reshape(-1)[dmask_c]
            dd = np.linalg.norm(dboxes[:, :2], axis=1) < distance_thresh + 0.5
            dboxes, dscores = dboxes[dd], dscores[dd]
            order = np.argsort(-dscores, kind="stable")
            dboxes, dscores = dboxes[order], dscores[order]
            ks = {int((dscores >= c).sum()) for c in SCORE_CUTOFFS}
            frame_stats.append(
                _frame_stats(dboxes, dscores, gboxes, level, thr, needed_ks=ks))
            frame_scores.append(dscores)

        for level in (1, 2):
            precisions, recalls, ph, rh = [], [], [], []
            for cutoff in SCORE_CUTOFFS:
                tp = fp = 0
                w_sum = 0.0
                for stats, scores in zip(frame_stats, frame_scores):
                    k = int((scores >= cutoff).sum())
                    t, f, w = stats[k][level]
                    tp += t
                    fp += f
                    w_sum += w
                denom_p = max(tp + fp, 1)
                denom_r = max(num_gt[level], 1)
                precisions.append(tp / denom_p if tp + fp else 1.0)
                recalls.append(tp / denom_r)
                ph.append(w_sum / denom_p if tp + fp else 1.0)
                rh.append(w_sum / denom_r)
            key = f"OBJECT_TYPE_TYPE_{cls.upper()}_LEVEL_{level}"
            results[f"{key}/AP"] = _ap_from_pr(precisions, recalls)
            results[f"{key}/APH"] = _ap_from_pr(ph, rh)
    return results


def format_waymo_results(results) -> str:
    lines = [f"{k}: {v:.4f}" for k, v in sorted(results.items())]
    return "\n".join(lines)
