"""KITTI AP evaluation with MODEST's range buckets — port of
``modest_tpu/eval/kitti_eval.py`` (reference
pcdet/datasets/kitti/kitti_object_eval_python/eval.py): 41-point R11/R40
interpolated AP, the official greedy matcher, and MODEST's additions —
camera-depth range filtering (eval.py:816-831) and the 'Dynamic' column of
min_overlaps where the reported "iou0.7" is IoU 0.5 and "iou0.5" is IoU 0.25
(eval.py:839-845).

Host numpy, as in the JAX package. Rotated BEV overlaps and the per-frame
matcher run in the host library (``utils/native.py``); without it the
overlaps come from ``ops/iou3d.py`` on CPU tensors and the matcher is
``compute_statistics`` below.
"""
from __future__ import annotations

from copy import deepcopy

import numpy as np

CLASS_TO_NAME = {
    0: "Car", 1: "Pedestrian", 2: "Cyclist", 3: "Van",
    4: "Person_sitting", 5: "Truck", 6: "Dynamic",
}
NAME_TO_CLASS = {v: k for k, v in CLASS_TO_NAME.items()}
N_SAMPLE_PTS = 41
NO_DETECTION = -10000000


def get_thresholds(scores: np.ndarray, num_gt: int, num_sample_pts: int = 41):
    scores = np.sort(scores)[::-1]
    current_recall = 0.0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)) and (
            i < len(scores) - 1
        ):
            continue
        thresholds.append(score)
        current_recall += 1 / (num_sample_pts - 1.0)
    return thresholds


def clean_data(gt_anno, dt_anno, current_class: int, difficulty: int):
    CLASS_NAMES = ["car", "pedestrian", "cyclist", "van", "person_sitting", "truck", "dynamic"]
    MIN_HEIGHT = [40, 25, 25]
    MAX_OCCLUSION = [0, 1, 2]
    MAX_TRUNCATION = [0.15, 0.3, 0.5]
    cls_name = CLASS_NAMES[current_class]
    dc_bboxes, ignored_gt, ignored_dt = [], [], []
    num_valid_gt = 0
    for i in range(len(gt_anno["name"])):
        bbox = gt_anno["bbox"][i]
        gt_name = str(gt_anno["name"][i]).lower()
        height = bbox[3] - bbox[1]
        if gt_name == cls_name:
            valid_class = 1
        elif cls_name == "pedestrian" and gt_name == "person_sitting":
            valid_class = 0
        elif cls_name == "car" and gt_name == "van":
            valid_class = 0
        else:
            valid_class = -1
        ignore = False
        if difficulty < 3 and (
            gt_anno["occluded"][i] > MAX_OCCLUSION[difficulty]
            or gt_anno["truncated"][i] > MAX_TRUNCATION[difficulty]
            or height <= MIN_HEIGHT[difficulty]
        ):
            ignore = True
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if str(gt_anno["name"][i]) == "DontCare":
            dc_bboxes.append(gt_anno["bbox"][i])
    for i in range(len(dt_anno["name"])):
        valid_class = 1 if str(dt_anno["name"][i]).lower() == cls_name else -1
        height = abs(dt_anno["bbox"][i, 3] - dt_anno["bbox"][i, 1])
        if difficulty in (0, 1, 2) and height < MIN_HEIGHT[difficulty]:
            ignored_dt.append(1)
        elif valid_class == 1:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    return num_valid_gt, ignored_gt, ignored_dt, dc_bboxes


# ---------------------------------------------------------------------------
# overlap matrices
# ---------------------------------------------------------------------------


def image_box_overlap(boxes, query_boxes, criterion=-1):
    """(N, 4) x (K, 4) axis-aligned 2D overlaps, vectorized."""
    n, k = boxes.shape[0], query_boxes.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k))
    iw = np.minimum(boxes[:, None, 2], query_boxes[None, :, 2]) - np.maximum(
        boxes[:, None, 0], query_boxes[None, :, 0]
    )
    ih = np.minimum(boxes[:, None, 3], query_boxes[None, :, 3]) - np.maximum(
        boxes[:, None, 1], query_boxes[None, :, 1]
    )
    inter = np.where((iw > 0) & (ih > 0), iw * ih, 0.0)
    area_b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    area_q = (query_boxes[:, 2] - query_boxes[:, 0]) * (query_boxes[:, 3] - query_boxes[:, 1])
    if criterion == -1:
        denom = area_b[:, None] + area_q[None, :] - inter
    elif criterion == 0:
        denom = np.broadcast_to(area_b[:, None], inter.shape)
    elif criterion == 1:
        denom = np.broadcast_to(area_q[None, :], inter.shape)
    else:
        denom = np.ones_like(inter)
    return np.where(inter > 0, inter / denom, 0.0)


def _to7(b5):
    """[x, z, l, w, ry] camera-BEV boxes → (N, 7) lidar-layout boxes.

    The (x, z) footprint of a camera box with heading ry corresponds to a
    rotation of −ry in a right-handed (x, z) plane.
    """
    n = b5.shape[0]
    out = np.zeros((n, 7), np.float32)
    out[:, 0] = b5[:, 0]
    out[:, 1] = b5[:, 1]
    out[:, 3] = b5[:, 2]
    out[:, 4] = b5[:, 3]
    out[:, 5] = 1.0
    out[:, 6] = -b5[:, 4]
    return out


def bev_box_overlap(boxes, qboxes, criterion=-1):
    """(N, 5) x (K, 5) rotated overlaps, [x, z, l, w, ry] camera BEV: the
    host library's double-precision clip, else ``ops/iou3d.py`` on CPU
    tensors (``utils/native.py::bev_overlap`` picks)."""
    from ..utils import native

    n, k = boxes.shape[0], qboxes.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k))
    ov = np.asarray(native.bev_overlap(_to7(boxes), _to7(qboxes)), np.float64)
    area_a = (boxes[:, 2] * boxes[:, 3])[:, None]
    area_b = (qboxes[:, 2] * qboxes[:, 3])[None, :]
    if criterion == -1:
        return ov / np.maximum(area_a + area_b - ov, 1e-8)
    if criterion == 0:
        return ov / np.maximum(area_a, 1e-8)
    if criterion == 1:
        return ov / np.maximum(area_b, 1e-8)
    return ov


def d3_box_overlap(boxes, qboxes, criterion=-1):
    """(N, 7) x (K, 7) camera boxes [x, y, z, l, h, w, ry] → 3D IoU.

    y is the box BOTTOM (KITTI labels); height extends upward (−y).
    """
    n, k = boxes.shape[0], qboxes.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k))
    bev = bev_box_overlap(boxes[:, [0, 2, 3, 5, 6]], qboxes[:, [0, 2, 3, 5, 6]], 2)
    iw = np.minimum(boxes[:, None, 1], qboxes[None, :, 1]) - np.maximum(
        boxes[:, None, 1] - boxes[:, None, 4], qboxes[None, :, 1] - qboxes[None, :, 4]
    )
    inc = np.where(iw > 0, iw * bev, 0.0)
    vol_a = (boxes[:, 3] * boxes[:, 4] * boxes[:, 5])[:, None]
    vol_b = (qboxes[:, 3] * qboxes[:, 4] * qboxes[:, 5])[None, :]
    if criterion == -1:
        denom = vol_a + vol_b - inc
    elif criterion == 0:
        denom = np.broadcast_to(vol_a, inc.shape).copy()
    elif criterion == 1:
        denom = np.broadcast_to(vol_b, inc.shape).copy()
    else:
        denom = np.ones_like(inc)
    return np.where(inc > 0, inc / np.maximum(denom, 1e-8), 0.0)


def _overlap_matrix(gt_anno, dt_anno, metric):
    """(n_dt, n_gt) overlap matrix for one frame."""
    if metric == 0:
        return image_box_overlap(dt_anno["bbox"], gt_anno["bbox"])
    if metric == 1:
        def b5(a):
            return np.concatenate(
                [a["location"][:, [0, 2]], a["dimensions"][:, [0, 2]],
                 a["rotation_y"][..., None]], axis=1
            )
        return bev_box_overlap(b5(dt_anno), b5(gt_anno))
    if metric == 2:
        def b7(a):
            return np.concatenate(
                [a["location"], a["dimensions"], a["rotation_y"][..., None]], axis=1
            )
        return d3_box_overlap(b7(dt_anno), b7(gt_anno))
    raise ValueError(metric)


# ---------------------------------------------------------------------------
# the official greedy matcher (reference compute_statistics_jit:160-278)
# ---------------------------------------------------------------------------


def compute_statistics(overlaps, gt_datas, dt_datas, ignored_gt, ignored_det,
                       dc_bboxes, metric, min_overlap, thresh=0.0,
                       compute_fp=False, compute_aos=False):
    det_size = dt_datas.shape[0]
    gt_size = gt_datas.shape[0]
    dt_scores = dt_datas[:, -1]
    dt_alphas = dt_datas[:, 4]
    gt_alphas = gt_datas[:, 4]
    dt_bboxes = dt_datas[:, :4]

    assigned_detection = np.zeros(det_size, bool)
    ignored_threshold = (dt_scores < thresh) if compute_fp else np.zeros(det_size, bool)

    tp = fp = fn = 0
    similarity = 0.0
    thresholds, delta = [], []
    for i in range(gt_size):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = NO_DETECTION
        max_overlap = 0.0
        assigned_ignored_det = False
        for j in range(det_size):
            if ignored_det[j] == -1 or assigned_detection[j] or ignored_threshold[j]:
                continue
            overlap = overlaps[j, i]
            dt_score = dt_scores[j]
            if not compute_fp and overlap > min_overlap and dt_score > valid_detection:
                det_idx = j
                valid_detection = dt_score
            elif (compute_fp and overlap > min_overlap
                  and (overlap > max_overlap or assigned_ignored_det)
                  and ignored_det[j] == 0):
                max_overlap = overlap
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = False
            elif (compute_fp and overlap > min_overlap
                  and valid_detection == NO_DETECTION and ignored_det[j] == 1):
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = True

        if valid_detection == NO_DETECTION and ignored_gt[i] == 0:
            fn += 1
        elif valid_detection != NO_DETECTION and (
            ignored_gt[i] == 1 or ignored_det[det_idx] == 1
        ):
            assigned_detection[det_idx] = True
        elif valid_detection != NO_DETECTION:
            tp += 1
            thresholds.append(dt_scores[det_idx])
            if compute_aos:
                delta.append(gt_alphas[i] - dt_alphas[det_idx])
            assigned_detection[det_idx] = True

    if compute_fp:
        fp = int(
            (~assigned_detection
             & (ignored_det != -1) & (ignored_det != 1)
             & ~ignored_threshold).sum()
        )
        nstuff = 0
        if metric == 0 and len(dc_bboxes) > 0:
            overlaps_dt_dc = image_box_overlap(dt_bboxes, np.asarray(dc_bboxes), 0)
            for i in range(len(dc_bboxes)):
                for j in range(det_size):
                    if (assigned_detection[j] or ignored_det[j] in (-1, 1)
                            or ignored_threshold[j]):
                        continue
                    if overlaps_dt_dc[j, i] > min_overlap:
                        assigned_detection[j] = True
                        nstuff += 1
        fp -= nstuff
        if compute_aos:
            tmp = [(1.0 + np.cos(d)) / 2.0 for d in delta]
            similarity = float(np.sum(tmp)) if (tp > 0 or fp > 0) else -1.0
    return tp, fp, fn, similarity, np.array(thresholds)


# ---------------------------------------------------------------------------
# class-level evaluation
# ---------------------------------------------------------------------------


def _prepare_data(gt_annos, dt_annos, current_class, difficulty):
    gt_datas_list, dt_datas_list = [], []
    ignored_gts, ignored_dets, dontcares = [], [], []
    total_num_valid_gt = 0
    for gt, dt in zip(gt_annos, dt_annos):
        num_valid_gt, ignored_gt, ignored_det, dc = clean_data(gt, dt, current_class, difficulty)
        ignored_gts.append(np.array(ignored_gt, np.int64))
        ignored_dets.append(np.array(ignored_det, np.int64))
        dontcares.append(np.stack(dc, 0).astype(np.float64) if dc else np.zeros((0, 4)))
        total_num_valid_gt += num_valid_gt
        gt_datas_list.append(
            np.concatenate([gt["bbox"], gt["alpha"][..., None]], 1)
            if len(gt["name"]) else np.zeros((0, 5))
        )
        dt_datas_list.append(
            np.concatenate([dt["bbox"], dt["alpha"][..., None], dt["score"][..., None]], 1)
            if len(dt["name"]) else np.zeros((0, 6))
        )
    return (gt_datas_list, dt_datas_list, ignored_gts, ignored_dets, dontcares,
            total_num_valid_gt)


def eval_class(gt_annos, dt_annos, current_classes, difficultys, metric,
               min_overlaps, compute_aos=False):
    assert len(gt_annos) == len(dt_annos)
    overlaps = [_overlap_matrix(gt, dt, metric) for gt, dt in zip(gt_annos, dt_annos)]

    num_minoverlap = len(min_overlaps)
    precision = np.zeros([len(current_classes), len(difficultys), num_minoverlap, N_SAMPLE_PTS])
    recall = np.zeros_like(precision)
    aos = np.zeros_like(precision)

    for m, current_class in enumerate(current_classes):
        for ld, difficulty in enumerate(difficultys):
            (gt_datas_list, dt_datas_list, ignored_gts, ignored_dets, dontcares,
             total_num_valid_gt) = _prepare_data(gt_annos, dt_annos, current_class, difficulty)
            for k, min_overlap in enumerate(min_overlaps[:, metric, m]):
                thresholdss = []
                for i in range(len(gt_annos)):
                    *_, th = compute_statistics(
                        overlaps[i], gt_datas_list[i], dt_datas_list[i],
                        ignored_gts[i], ignored_dets[i], dontcares[i],
                        metric, min_overlap=min_overlap, thresh=0.0, compute_fp=False,
                    )
                    thresholdss += th.tolist()
                thresholds = np.array(get_thresholds(np.array(thresholdss), total_num_valid_gt))
                pr = np.zeros([len(thresholds), 4])
                for i in range(len(gt_annos)):
                    # hot path: the native C++ matcher handles all thresholds
                    # of one frame in one call (metric>0: no DontCare boxes,
                    # no aos needed for the Dynamic protocol)
                    native_out = None
                    if metric != 0 and not compute_aos and len(dontcares[i]) == 0:
                        from ..utils import native

                        native_out = native.match_stats(
                            overlaps[i], dt_datas_list[i][:, -1],
                            ignored_gts[i], ignored_dets[i],
                            min_overlap, thresholds,
                        )
                    if native_out is not None:
                        pr[:, :3] += native_out
                        continue
                    for t, thr in enumerate(thresholds):
                        tp, fp, fn, sim, _ = compute_statistics(
                            overlaps[i], gt_datas_list[i], dt_datas_list[i],
                            ignored_gts[i], ignored_dets[i], dontcares[i],
                            metric, min_overlap=min_overlap, thresh=thr,
                            compute_fp=True, compute_aos=compute_aos,
                        )
                        pr[t, 0] += tp
                        pr[t, 1] += fp
                        pr[t, 2] += fn
                        if sim != -1:
                            pr[t, 3] += sim
                for i in range(len(thresholds)):
                    recall[m, ld, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 2])
                    precision[m, ld, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 1])
                    if compute_aos:
                        aos[m, ld, k, i] = pr[i, 3] / (pr[i, 0] + pr[i, 1])
                for i in range(len(thresholds)):
                    precision[m, ld, k, i] = np.max(precision[m, ld, k, i:], axis=-1)
                    if compute_aos:
                        aos[m, ld, k, i] = np.max(aos[m, ld, k, i:], axis=-1)
    return {"recall": recall, "precision": precision, "orientation": aos}


def get_mAP(prec):
    return sum(prec[..., i] for i in range(0, prec.shape[-1], 4)) / 11 * 100


def get_mAP_R40(prec):
    return sum(prec[..., i] for i in range(1, prec.shape[-1])) / 40 * 100


def do_eval(gt_annos, dt_annos, current_classes, min_overlaps, compute_aos=False,
            difficultys=(0, 1, 2)):
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 0,
                     min_overlaps, compute_aos)
    mAP_bbox = get_mAP(ret["precision"])
    mAP_bbox_R40 = get_mAP_R40(ret["precision"])
    mAP_aos = mAP_aos_R40 = None
    if compute_aos:
        mAP_aos = get_mAP(ret["orientation"])
        mAP_aos_R40 = get_mAP_R40(ret["orientation"])
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 1, min_overlaps)
    mAP_bev = get_mAP(ret["precision"])
    mAP_bev_R40 = get_mAP_R40(ret["precision"])
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 2, min_overlaps)
    mAP_3d = get_mAP(ret["precision"])
    mAP_3d_R40 = get_mAP_R40(ret["precision"])
    return (mAP_bbox, mAP_bev, mAP_3d, mAP_aos,
            mAP_bbox_R40, mAP_bev_R40, mAP_3d_R40, mAP_aos_R40)


def _compute_aos_flag(dt_annos):
    for anno in dt_annos:
        if anno["alpha"].shape[0] != 0:
            return anno["alpha"][0] != -10
    return False


def get_official_eval_result(gt_annos, dt_annos, current_classes):
    overlap_0_7 = np.array([[0.7, 0.5, 0.5, 0.7, 0.5, 0.7, 0.5],
                            [0.7, 0.5, 0.5, 0.7, 0.5, 0.7, 0.5],
                            [0.7, 0.5, 0.5, 0.7, 0.5, 0.7, 0.5]])
    overlap_0_5 = np.array([[0.7, 0.5, 0.5, 0.7, 0.5, 0.5, 0.5],
                            [0.5, 0.25, 0.25, 0.5, 0.25, 0.5, 0.25],
                            [0.5, 0.25, 0.25, 0.5, 0.25, 0.5, 0.25]])
    min_overlaps = np.stack([overlap_0_7, overlap_0_5], axis=0)
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    classes_int = [NAME_TO_CLASS[c] if isinstance(c, str) else c for c in current_classes]
    min_overlaps = min_overlaps[:, :, classes_int]
    compute_aos = _compute_aos_flag(dt_annos)
    (mAPbbox, mAPbev, mAP3d, mAPaos, mAPbbox_R40, mAPbev_R40, mAP3d_R40,
     mAPaos_R40) = do_eval(gt_annos, dt_annos, classes_int, min_overlaps, compute_aos)
    result = ""
    ret_dict = {}
    for j, curcls in enumerate(classes_int):
        name = CLASS_TO_NAME[curcls]
        for i in range(min_overlaps.shape[0]):
            result += (f"{name} AP_R40@{min_overlaps[i, 0, j]:.2f}: "
                       f"bbox {mAPbbox_R40[j, :, i]}, bev {mAPbev_R40[j, :, i]}, "
                       f"3d {mAP3d_R40[j, :, i]}\n")
            if i == 0:
                for d, dn in enumerate(["easy", "moderate", "hard"]):
                    ret_dict[f"{name}_3d/{dn}_R40"] = mAP3d_R40[j, d, 0]
                    ret_dict[f"{name}_bev/{dn}_R40"] = mAPbev_R40[j, d, 0]
                    ret_dict[f"{name}_image/{dn}_R40"] = mAPbbox_R40[j, d, 0]
    return result, ret_dict


COCO_CLASS_RANGES = {
    0: [0.5, 0.95, 10], 1: [0.25, 0.7, 10], 2: [0.25, 0.7, 10],
    3: [0.5, 0.95, 10], 4: [0.25, 0.7, 10], 5: [0.5, 0.95, 10],
    6: [0.5, 0.95, 10],
}


def do_coco_style_eval(gt_annos, dt_annos, current_classes, overlap_ranges,
                       compute_aos=False):
    """COCO-style AP: mean over a linspace of IoU thresholds per class
    (reference eval.py:626-643). overlap_ranges (3, metric, class) =
    [start, stop, num] per (metric, class)."""
    min_overlaps = np.zeros([10, *overlap_ranges.shape[1:]])
    for i in range(overlap_ranges.shape[1]):
        for j in range(overlap_ranges.shape[2]):
            start, stop, num = overlap_ranges[:, i, j]
            min_overlaps[:, i, j] = np.linspace(start, stop, int(num))
    (mAP_bbox, mAP_bev, mAP_3d, mAP_aos, *_r40) = do_eval(
        gt_annos, dt_annos, current_classes, min_overlaps, compute_aos)
    mAP_bbox = mAP_bbox.mean(-1)
    mAP_bev = mAP_bev.mean(-1)
    mAP_3d = mAP_3d.mean(-1)
    if mAP_aos is not None:
        mAP_aos = mAP_aos.mean(-1)
    return mAP_bbox, mAP_bev, mAP_3d, mAP_aos


def get_coco_eval_result(gt_annos, dt_annos, current_classes):
    """COCO-style KITTI result (reference eval.py:754-833, dormant in the
    reference's drivers but part of its eval surface)."""
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    classes_int = [NAME_TO_CLASS[c] if isinstance(c, str) else c
                   for c in current_classes]
    overlap_ranges = np.zeros([3, 3, len(classes_int)])
    for i, curcls in enumerate(classes_int):
        overlap_ranges[:, :, i] = np.array(COCO_CLASS_RANGES[curcls])[:, None]
    compute_aos = _compute_aos_flag(dt_annos)
    mAPbbox, mAPbev, mAP3d, mAPaos = do_coco_style_eval(
        gt_annos, dt_annos, classes_int, overlap_ranges, compute_aos)
    result = ""
    ret_dict = {}
    for j, curcls in enumerate(classes_int):
        name = CLASS_TO_NAME[curcls]
        start, stop, num = COCO_CLASS_RANGES[curcls]
        step = (stop - start) / (num - 1)
        result += f"{name} coco AP@{start:.2f}:{step:.2f}:{stop:.2f}:\n"
        result += (f"bbox AP:{mAPbbox[j, 0]:.2f}, {mAPbbox[j, 1]:.2f}, "
                   f"{mAPbbox[j, 2]:.2f}\n")
        result += (f"bev  AP:{mAPbev[j, 0]:.2f}, {mAPbev[j, 1]:.2f}, "
                   f"{mAPbev[j, 2]:.2f}\n")
        result += (f"3d   AP:{mAP3d[j, 0]:.2f}, {mAP3d[j, 1]:.2f}, "
                   f"{mAP3d[j, 2]:.2f}\n")
        if compute_aos:
            result += (f"aos  AP:{mAPaos[j, 0]:.2f}, {mAPaos[j, 1]:.2f}, "
                       f"{mAPaos[j, 2]:.2f}\n")
        for d, dn in enumerate(["easy", "moderate", "hard"]):
            ret_dict[f"{name}_coco_3d/{dn}"] = mAP3d[j, d]
            ret_dict[f"{name}_coco_bev/{dn}"] = mAPbev[j, d]
    return result, ret_dict


def filter_det_range(dets, close, far):
    """Keep boxes with camera depth |z| in (close, far] (reference :816-831)."""
    dets = deepcopy(dets)
    if dets["location"].shape[0] == 0:
        return dets
    valid = (np.abs(dets["location"][:, 2]) > close) & (
        np.abs(dets["location"][:, 2]) <= far
    )
    for k in dets:
        if k in ("frame_id", "gt_boxes_lidar"):
            continue
        dets[k] = dets[k][valid]
    return dets


def get_range_eval_result(gt_annos, dt_annos, current_classes, ranges=(0, 30, 50, 80)):
    """MODEST's range-bucketed R40 AP (reference :834-927).

    NOTE: for 'Dynamic' the "iou0.7" outputs use IoU 0.5 and the "iou0.5"
    outputs use IoU 0.25 (min_overlaps column 6) — the paper's protocol.
    """
    overlap_0_7 = np.array([[0.7, 0.5, 0.5, 0.7, 0.5, 0.7, 0.5],
                            [0.7, 0.5, 0.5, 0.7, 0.5, 0.7, 0.5],
                            [0.7, 0.5, 0.5, 0.7, 0.5, 0.7, 0.5]])
    overlap_0_5 = np.array([[0.7, 0.5, 0.5, 0.7, 0.5, 0.5, 0.5],
                            [0.5, 0.25, 0.25, 0.5, 0.25, 0.5, 0.25],
                            [0.5, 0.25, 0.25, 0.5, 0.25, 0.5, 0.25]])
    min_overlaps = np.stack([overlap_0_7, overlap_0_5], axis=0)
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    classes_int = [NAME_TO_CLASS[c] if isinstance(c, str) else c for c in current_classes]
    min_overlaps = min_overlaps[:, :, classes_int]
    compute_aos = _compute_aos_flag(dt_annos)

    range_pairs = [(ranges[i], ranges[i + 1]) for i in range(len(ranges) - 1)]
    range_pairs.append((ranges[0], ranges[-1]))

    ret_dict = {}
    for range_s, range_e in range_pairs:
        dt_r = [filter_det_range(d, range_s, range_e) for d in dt_annos]
        gt_r = [filter_det_range(g, range_s, range_e) for g in gt_annos]
        _, _, _, _, _, mAPbev_R40, mAP3d_R40, _ = do_eval(
            gt_r, dt_r, classes_int, min_overlaps, compute_aos, difficultys=[3]
        )
        for j, curcls in enumerate(classes_int):
            name = CLASS_TO_NAME[curcls]
            ret_dict[f"{name}_3d_iou0.7/{range_s:02d}-{range_e:02d}_R40"] = mAP3d_R40[j, 0, 0]
            ret_dict[f"{name}_3d_iou0.5/{range_s:02d}-{range_e:02d}_R40"] = mAP3d_R40[j, 0, 1]
            ret_dict[f"{name}_bev_iou0.7/{range_s:02d}-{range_e:02d}_R40"] = mAPbev_R40[j, 0, 0]
            ret_dict[f"{name}_bev_iou0.5/{range_s:02d}-{range_e:02d}_R40"] = mAPbev_R40[j, 0, 1]

    result = ""
    for curcls in classes_int:
        name = CLASS_TO_NAME[curcls]
        header = "RANGE " + "  ".join(f"{s:02d}-{e:02d} " for s, e in range_pairs) + "\n"
        for tag, label in (("iou0.7", "IoU 0.5"), ("iou0.5", "IoU 0.25")):
            bev = [ret_dict[f"{name}_bev_{tag}/{s:02d}-{e:02d}_R40"] for s, e in range_pairs]
            d3 = [ret_dict[f"{name}_3d_{tag}/{s:02d}-{e:02d}_R40"] for s, e in range_pairs]
            result += f"{name} {label} (reported as {tag}):\n" + header
            result += "BEV:  " + ", ".join(f"{x:6.3f}" for x in bev) + "\n"
            result += "3D :  " + ", ".join(f"{x:6.3f}" for x in d3) + "\n"
    return result, ret_dict


# ---------------------------------------------------------------------------
# lidar-frame AP (SDK-free fallback for the nuScenes / Waymo drivers)
# ---------------------------------------------------------------------------


def _lidar_bev_iou_np(boxes_a, boxes_b):
    """(N, 7) x (K, 7) lidar boxes → rotated BEV IoU (numpy in/out): the
    host library, else ``ops/iou3d.py`` on CPU tensors."""
    if boxes_a.shape[0] == 0 or boxes_b.shape[0] == 0:
        return np.zeros((boxes_a.shape[0], boxes_b.shape[0]))
    from ..utils import native

    return np.asarray(native.bev_iou(np.asarray(boxes_a), np.asarray(boxes_b)), np.float64)


def ap_from_lidar_annos(gt_annos, dt_annos, class_names,
                        iou_thresholds=(0.7, 0.5)):
    """R40 AP per class over lidar-frame annos {name, boxes_lidar[, score]}.

    A self-contained evaluator for datasets whose official metric needs an
    SDK that may be absent (nuScenes NDS, Waymo LET): greedy score-ordered
    matching at rotated BEV IoU, the same matching rule the KITTI harness
    uses, reported as R40 AP per class and threshold.
    """
    assert len(gt_annos) == len(dt_annos)
    results = {}
    lines = []
    for cls in class_names:
        # gather per-frame class subsets
        gts = [np.asarray(g["boxes_lidar"])[np.asarray(g["name"]) == cls]
               if len(g["name"]) else np.zeros((0, 7)) for g in gt_annos]
        dts, scores, frame_ids = [], [], []
        for fi, d in enumerate(dt_annos):
            m = np.asarray(d["name"]) == cls if len(d["name"]) else np.zeros(0, bool)
            dts.append(np.asarray(d["boxes_lidar"])[m])
            scores.append(np.asarray(d["score"])[m])
            frame_ids.append(np.full(int(m.sum()), fi))
        num_gt = int(sum(len(g) for g in gts))
        all_scores = np.concatenate(scores) if scores else np.zeros(0)
        order = np.argsort(-all_scores, kind="stable")
        all_boxes = np.concatenate(dts) if dts else np.zeros((0, 7))
        all_frames = np.concatenate(frame_ids).astype(int) if frame_ids else np.zeros(0, int)
        ious = {fi: _lidar_bev_iou_np(dts[fi], gts[fi])
                for fi in range(len(gt_annos)) if len(dts[fi])}
        # per-frame local det index
        local_idx = np.concatenate(
            [np.arange(len(d)) for d in dts]) if dts else np.zeros(0, int)
        for thr in iou_thresholds:
            matched = [np.zeros(len(g), bool) for g in gts]
            tp = np.zeros(len(order))
            fp = np.zeros(len(order))
            for rank, di in enumerate(order):
                fi = all_frames[di]
                li = local_idx[di]
                iou_row = ious.get(fi)
                if iou_row is None or iou_row.shape[1] == 0:
                    fp[rank] = 1
                    continue
                j = int(np.argmax(np.where(matched[fi], -1.0, iou_row[li])))
                if iou_row[li, j] >= thr and not matched[fi][j]:
                    matched[fi][j] = True
                    tp[rank] = 1
                else:
                    fp[rank] = 1
            if num_gt == 0:
                ap = 0.0
            else:
                cum_tp = np.cumsum(tp)
                cum_fp = np.cumsum(fp)
                recall = cum_tp / num_gt
                precision = cum_tp / np.maximum(cum_tp + cum_fp, 1)
                ap = 0.0
                for r in np.linspace(1 / 40, 1.0, 40):  # R40 sampling
                    p = precision[recall >= r]
                    ap += (p.max() if len(p) else 0.0) / 40
            results[f"{cls}_bev_iou{thr}_R40"] = float(ap * 100)
            lines.append(f"{cls} BEV AP@{thr} (R40): {ap * 100:6.2f}")
    return "\n".join(lines) + "\n", results
