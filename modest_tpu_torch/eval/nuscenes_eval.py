"""SDK-free nuScenes detection metric — port of
``modest_tpu/eval/nuscenes_eval.py`` (mAP @ center-distance + TP errors +
NDS), following the official protocol of the nuscenes devkit
(nuscenes/eval/detection/algo.py accumulate/calc_ap/calc_tp and
data_classes.py DetectionMetrics) so pods without the SDK report the same
numbers the reference gets through NuScenesEval
(reference pcdet/datasets/nuscenes/nuscenes_dataset.py:199-263).

Inputs are the framework's lidar-frame annos ({name, score, boxes_lidar
(N, 7|9)}); center distance / orientation / scale / velocity errors are
rigid-transform invariant, so evaluating in the lidar frame matches the
devkit's global-frame numbers for the same matches.

Protocol coverage: per-class eval-range + zero-lidar-point gt filtering
(devkit filter_eval_boxes) runs on both sides; the recall-span convention
for TP errors matches the devkit's last-nonzero-confidence index.

Deviation (documented): ground truth here carries no attribute labels, so
the attribute error (AAE) term is omitted and NDS renormalizes over the
remaining 9 terms (5*mAP + 4 TP scores). Classes without velocity ground
truth (7-dim boxes) likewise skip AVE.
"""
from __future__ import annotations

import numpy as np

DIST_THS = (0.5, 1.0, 2.0, 4.0)
DIST_TH_TP = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
MEAN_AP_WEIGHT = 5
MAX_BOXES_PER_SAMPLE = 500
N_REC = 101  # 101-point interpolated curves

# devkit class-capability table (nuscenes/eval/detection/evaluate.py):
# barriers have no velocity/attribute; cones additionally no orientation
_NO_VELOCITY = {"barrier", "traffic_cone"}
_NO_ORIENT = {"traffic_cone"}

# detection_cvpr_2019 per-class evaluation range (m from ego); boxes beyond
# are dropped from BOTH gt and predictions (devkit filter_eval_boxes)
CLASS_RANGE = {
    "car": 50, "truck": 50, "bus": 50, "trailer": 50,
    "construction_vehicle": 50, "pedestrian": 40, "motorcycle": 40,
    "bicycle": 40, "traffic_cone": 30, "barrier": 30,
}
_DEFAULT_RANGE = 50

_TP_METRICS = ("trans_err", "scale_err", "orient_err", "vel_err")


def filter_eval_boxes(frames, is_gt: bool):
    """Devkit filter_eval_boxes: drop boxes beyond their class's eval range
    (ego distance ≡ lidar-frame √(x²+y²)) and gt boxes with zero lidar
    points (when the annos carry 'num_lidar_pts')."""
    out = []
    for f in frames:
        names = np.asarray(f["name"])
        if len(names) == 0:
            out.append(f)
            continue
        boxes = np.asarray(f["boxes_lidar"]).reshape(len(names), -1)
        limits = np.array([CLASS_RANGE.get(str(n), _DEFAULT_RANGE)
                           for n in names])
        keep = np.hypot(boxes[:, 0], boxes[:, 1]) < limits
        if is_gt and "num_lidar_pts" in f:
            keep &= np.asarray(f["num_lidar_pts"]) > 0
        g = {"name": names[keep], "boxes_lidar": boxes[keep]}
        if "score" in f:
            g["score"] = np.asarray(f["score"])[keep]
        out.append(g)
    return out


def _cummean(x: np.ndarray) -> np.ndarray:
    """Cumulative mean ignoring NaNs (devkit utils.cummean)."""
    if np.all(np.isnan(x)):
        return np.ones(len(x))
    good = ~np.isnan(x)
    return np.nancumsum(x) / np.maximum(np.cumsum(good), 1)


def _yaw_diff(a: np.ndarray, b: np.ndarray, period: float = 2 * np.pi):
    d = np.abs(a - b) % period
    return np.minimum(d, period - d)


def _aligned_iou_1d(gt_whl, det_whl) -> float:
    """Scale error's size-only 3D IoU: boxes coaxial at a common center
    (devkit scale_iou)."""
    inter = np.prod(np.minimum(gt_whl, det_whl))
    union = np.prod(gt_whl) + np.prod(det_whl) - inter
    return float(inter / union)


def accumulate(gt_frames, det_frames, class_name: str, dist_th: float):
    """One (class, dist_th) PR sweep (devkit algo.accumulate).

    gt_frames/det_frames: per-frame dicts with 'name' (N,), 'boxes_lidar'
    (N, 7|9) [x y z dx dy dz yaw (vx vy)]; det frames also have 'score'.
    Returns an md dict with the 101-point interpolated curves, or None when
    the class has no ground truth anywhere.
    """
    npos = sum(int(np.sum(np.asarray(g["name"]) == class_name)) for g in gt_frames)
    if npos == 0:
        return None

    # flatten detections of this class, keeping frame ids; cap per frame
    rows = []
    for fi, d in enumerate(det_frames):
        names = np.asarray(d["name"])
        sel = np.nonzero(names == class_name)[0]
        order = np.argsort(-np.asarray(d["score"])[sel])[:MAX_BOXES_PER_SAMPLE]
        for j in sel[order]:
            rows.append((float(d["score"][j]), fi, int(j)))
    rows.sort(key=lambda r: -r[0])

    tp, fp, conf = [], [], []
    match = {k: [] for k in _TP_METRICS}
    match_conf = []
    taken = set()  # (frame, gt_idx)
    for score, fi, j in rows:
        det_box = np.asarray(det_frames[fi]["boxes_lidar"][j], np.float64)
        g = gt_frames[fi]
        g_names = np.asarray(g["name"])
        best, best_k = np.inf, -1
        for k in np.nonzero(g_names == class_name)[0]:
            if (fi, int(k)) in taken:
                continue
            gb = np.asarray(g["boxes_lidar"][k], np.float64)
            dist = float(np.hypot(gb[0] - det_box[0], gb[1] - det_box[1]))
            if dist < best:
                best, best_k = dist, int(k)
        conf.append(score)
        if best < dist_th:
            taken.add((fi, best_k))
            tp.append(1)
            fp.append(0)
            gb = np.asarray(g["boxes_lidar"][best_k], np.float64)
            match["trans_err"].append(best)
            match["scale_err"].append(1.0 - _aligned_iou_1d(gb[3:6], det_box[3:6]))
            period = np.pi if class_name == "barrier" else 2 * np.pi
            match["orient_err"].append(
                np.nan if class_name in _NO_ORIENT
                else float(_yaw_diff(gb[6], det_box[6], period)))
            if class_name in _NO_VELOCITY or gb.shape[0] < 9 or det_box.shape[0] < 9:
                match["vel_err"].append(np.nan)
            else:
                match["vel_err"].append(
                    float(np.hypot(gb[7] - det_box[7], gb[8] - det_box[8])))
            match_conf.append(score)
        else:
            tp.append(0)
            fp.append(1)

    if len(match_conf) == 0:  # no matches at all → AP 0, TP errors worst
        return {"precision": np.zeros(N_REC), "recall": np.linspace(0, 1, N_REC),
                "confidence": np.zeros(N_REC),
                **{k: np.ones(N_REC) for k in _TP_METRICS},
                "max_recall_ind": 0, "npos": npos,
                "has_vel": True}  # unknowable with 0 matches: keep the
                                  # worst-case 1.0 rather than skipping

    tp_c = np.cumsum(tp).astype(np.float64)
    fp_c = np.cumsum(fp).astype(np.float64)
    prec = tp_c / (tp_c + fp_c)
    rec = tp_c / float(npos)

    rec_interp = np.linspace(0, 1, N_REC)
    prec_i = np.interp(rec_interp, rec, prec, right=0)
    conf_i = np.interp(rec_interp, rec, conf, right=0)
    # devkit max_recall_ind: last recall-grid index with nonzero confidence
    nz = np.nonzero(conf_i)[0]
    out = {"precision": prec_i, "recall": rec_interp, "confidence": conf_i,
           "max_recall_ind": int(nz[-1]) if len(nz) else 0, "npos": npos,
           "has_vel": bool(np.any(~np.isnan(match["vel_err"])))}
    for k in _TP_METRICS:
        tmp = _cummean(np.asarray(match[k], np.float64))
        # curves are functions of confidence, resampled onto the recall grid
        # (devkit accumulate tail): interp needs ascending x → flip
        out[k] = np.interp(conf_i[::-1], np.asarray(match_conf)[::-1], tmp[::-1])[::-1]
    return out


def calc_ap(md) -> float:
    """Normalized AP above the (0.1, 0.1) operating floor (devkit calc_ap)."""
    prec = np.copy(md["precision"])
    prec = prec[round(100 * MIN_RECALL) + 1:]
    prec -= MIN_PRECISION
    prec[prec < 0] = 0
    return min(float(np.mean(prec)) / (1.0 - MIN_PRECISION), 1.0)


def calc_tp(md, metric_name: str) -> float:
    """Mean TP error over the achieved-recall span (devkit calc_tp)."""
    first = round(100 * MIN_RECALL) + 1
    last = md["max_recall_ind"]
    if last < first:
        return 1.0
    return float(np.mean(md[metric_name][first:last + 1]))


def nuscenes_eval(gt_frames, det_frames, class_names, pred_velocity=True):
    """Full metric suite → (result_str, metrics_dict with mAP/NDS/per-class).

    gt_frames: per-frame {name, boxes_lidar}; det_frames: {name, score,
    boxes_lidar} — the framework's generate_prediction_dicts output.
    """
    gt_frames = filter_eval_boxes(gt_frames, is_gt=True)
    det_frames = filter_eval_boxes(det_frames, is_gt=False)
    label_aps = {}
    label_tps = {}
    for cls in class_names:
        md_tp = None
        aps = {}
        for dist_th in DIST_THS:
            md = accumulate(gt_frames, det_frames, cls, dist_th)
            if md is None:
                break
            aps[dist_th] = calc_ap(md)
            if dist_th == DIST_TH_TP:
                md_tp = md
        if not aps:
            continue
        label_aps[cls] = aps
        tps = {}
        for m in _TP_METRICS:
            if m == "vel_err" and (cls in _NO_VELOCITY or not pred_velocity
                                   or not md_tp.get("has_vel", False)):
                continue
            if m == "orient_err" and cls in _NO_ORIENT:
                continue
            tps[m] = calc_tp(md_tp, m)
        label_tps[cls] = tps

    if not label_aps:
        return "no evaluable classes\n", {"mAP": 0.0, "NDS": 0.0}

    mean_ap = float(np.mean([ap for aps in label_aps.values()
                             for ap in aps.values()]))
    tp_errors = {}
    for m in _TP_METRICS:
        vals = [t[m] for t in label_tps.values() if m in t]
        if vals:
            tp_errors[m] = float(np.mean(vals))
    # NDS without the attribute term (no attribute labels in this pipeline):
    # (5*mAP + Σ (1 - min(1, err))) / (5 + #terms)
    tp_scores = [max(1.0 - min(1.0, e), 0.0) for e in tp_errors.values()]
    nds = (MEAN_AP_WEIGHT * mean_ap + sum(tp_scores)) / (
        MEAN_AP_WEIGHT + len(tp_scores))

    short = {"trans_err": "mATE", "scale_err": "mASE", "orient_err": "mAOE",
             "vel_err": "mAVE"}
    lines = ["--- nuScenes detection metric (SDK-free, official protocol; "
             "AAE omitted: no attribute labels) ---"]
    result = {}
    for cls, aps in label_aps.items():
        ap_str = " ".join(f"AP@{d}={v:.4f}" for d, v in sorted(aps.items()))
        tp_str = " ".join(f"{short[m]}={v:.4f}"
                          for m, v in label_tps[cls].items())
        lines.append(f"{cls}: {ap_str} | {tp_str}")
        result[f"{cls}_AP"] = float(np.mean(list(aps.values())))
    for m, v in tp_errors.items():
        result[short[m]] = v
        lines.append(f"{short[m]}: {v:.4f}")
    lines.append(f"mAP: {mean_ap:.4f}  NDS: {nds:.4f}")
    result["mAP"] = mean_ap
    result["NDS"] = nds
    return "\n".join(lines) + "\n", result
