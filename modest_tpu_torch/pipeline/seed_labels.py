"""Seed labels: PP-gated clustering → per-point seed masks and boxes, then
KITTI label files and the self-training label fusion.

Port of ``modest_tpu/pipeline/seed_labels.py``. Per frame: the
above-ground ∧ in-range mask (RANSAC ground plane), DBSCAN over the PP-gated
mutual-kNN graph on the device, the cluster validity filters, then one box
per surviving cluster, volume-filtered. Label files: BEV NMS over a frame's
boxes on the device (``ops/iou3d.py::nms_bev``), a camera-FOV filter and
KITTI label lines; fusion PP-filters a detector's boxes and merges them with
the seed boxes.
"""
from __future__ import annotations

import types

import numpy as np
import torch

from ..ops.iou3d import nms_bev
from ..utils import kitti_io
from ..utils.device import StageTimer, resolve_device, stage
from .box_fit import fit_objs_batched, fit_objs_grouped
from .clustering import dbscan_pp, dbscan_pp_many
from .ground_plane import above_plane, distance_to_plane, estimate_plane


def is_valid_cluster(ptc, pp_score, plane, min_points=10, max_volume=40, min_volume=0.5,
                     max_min_height=4, min_max_height=0, percentile=10,
                     min_percentile_pp_score=0.7) -> bool:
    """The validity rule of one cluster (reference clustering_utils.py:94-135)
    that ``filter_labels`` applies to every cluster at once: at least
    ``min_points`` points, touching the ground (lowest point at most
    ``max_min_height`` over ``plane``), tall enough (highest at least
    ``min_max_height``), and ephemeral (the ``percentile`` of its PP scores at
    most ``min_percentile_pp_score``). The volume bounds are the box fit's and
    unused here, as in the JAX package."""
    if ptc.shape[0] < min_points:
        return False
    dist = distance_to_plane(ptc, plane, directional=True)
    if dist.min() > max_min_height:
        return False
    if dist.max() < min_max_height:
        return False
    if np.percentile(pp_score, percentile) > min_percentile_pp_score:
        return False
    return True


def _compact_ids(labels: np.ndarray) -> np.ndarray:
    """Each label → its rank among the distinct values present (what
    np.unique + searchsorted give), through a lookup table over the id range."""
    if labels.size == 0:
        return labels.astype(np.int64)
    lo = int(labels.min())
    present = np.zeros(int(labels.max()) - lo + 1, bool)
    shifted = labels - lo
    present[shifted] = True
    ranks = np.cumsum(present) - 1
    return ranks[shifted]


def filter_labels(ptc, pp_score, labels, min_points=10, max_volume=40, min_volume=0.5,
                  max_min_height=4, min_max_height=0, percentile=10,
                  min_percentile_pp_score=0.7) -> np.ndarray:
    """Drop invalid clusters and compact ids; noise (-1) → 0, clusters → 1..K.
    A cluster is invalid with fewer than ``min_points`` points, when its
    lowest point is above ``max_min_height`` over the ground, when its
    highest is below ``min_max_height``, or when the ``percentile`` of its
    PP scores is above ``min_percentile_pp_score`` (persistent)."""
    labels = labels.copy()
    plane = estimate_plane(ptc, max_hs=-1.5, ptc_range=((-70, 70), (-50, 50)))
    n_clusters = int(labels.max()) + 1
    if n_clusters > 0:
        sel = labels >= 0
        lab = labels[sel]
        dist = distance_to_plane(ptc[sel, :3], plane, directional=True)
        counts = np.bincount(lab, minlength=n_clusters)
        dmin = np.full(n_clusters, np.inf)
        np.minimum.at(dmin, lab, dist)
        dmax = np.full(n_clusters, -np.inf)
        np.maximum.at(dmax, lab, dist)
        # per-cluster np.percentile (linear interpolation): one sort by
        # (label, pp), then interpolate inside each segment
        order = np.lexsort((pp_score[sel], lab))
        pps = pp_score[sel][order]
        starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
        pos = (counts - 1) * (percentile / 100.0)
        lo = np.floor(pos).astype(np.int64)
        hi = np.ceil(pos).astype(np.int64)
        nonempty = counts > 0
        v_lo = pps[starts + np.where(nonempty, lo, 0)]
        v_hi = pps[starts + np.where(nonempty, hi, 0)]
        perc = v_lo + (v_hi - v_lo) * (pos - lo)
        invalid = (
            (counts < min_points)
            | (dmin > max_min_height)
            | (dmax < min_max_height)
            | (nonempty & (perc > min_percentile_pp_score))
        )
        kill = (labels >= 0) & invalid[np.clip(labels, 0, None)]
        labels[kill] = -1
    return _compact_ids(labels)


def _t(pair):
    return tuple(tuple(p) for p in pair)


def _frame_final_mask(ptc: np.ndarray, cfg) -> np.ndarray:
    """Above-ground ∧ in-range mask."""
    pe = cfg.plane_estimate
    plane = estimate_plane(ptc[:, :3], max_hs=pe.max_hs, ptc_range=_t(pe.range))
    plane_mask = above_plane(ptc[:, :3], plane, offset=pe.offset, only_range=_t(pe.range))
    lr = cfg.limit_range
    range_mask = (
        (ptc[:, 0] <= lr[0][1]) & (ptc[:, 0] > lr[0][0])
        & (ptc[:, 1] <= lr[1][1]) & (ptc[:, 1] > lr[1][0])
    )
    return plane_mask & range_mask


def _check_clustering_cfg(cfg):
    if cfg.clustering.method != "DBSCAN":
        raise NotImplementedError(cfg.clustering.method)
    if cfg.graph.neighbor_type != "radius_mutual_knn" or cfg.graph.affinity_type != "l1":
        raise NotImplementedError(f"graph {cfg.graph.neighbor_type} / {cfg.graph.affinity_type}")


def _dbscan_kwargs(cfg) -> dict:
    return dict(n_neighbors=cfg.graph.n_neighbors, radius=cfg.graph.radius,
                eps=cfg.clustering.DBSCAN.eps, min_samples=cfg.clustering.DBSCAN.min_samples)


def _finish_frame(labels: np.ndarray, fit_results, cfg):
    """Volume-filter fitted boxes, zero out rejected clusters, compact ids."""
    objs = []
    lut = np.arange(int(labels.max()) + 1, dtype=labels.dtype)
    for i, obj in fit_results:
        if cfg.filtering.min_volume < obj.volume < cfg.filtering.max_volume:
            objs.append(obj)
        else:
            lut[i] = 0
    return _compact_ids(lut[labels]), objs


def generate_mask_for_frame(ptc: np.ndarray, pp_score: np.ndarray, calib, cfg, device="cuda",
                            timer: StageTimer | None = None):
    """ptc: (N, 4) velodyne points; pp_score: (N,). Returns (labels, objs)."""
    dev = resolve_device(device)
    _check_clustering_cfg(cfg)
    with stage(timer, "plane"):
        final_mask = _frame_final_mask(ptc, cfg)
    labels = np.full(ptc.shape[0], -1, dtype=np.int64)
    labels[final_mask] = dbscan_pp(ptc[final_mask, :3], pp_score[final_mask],
                                   **_dbscan_kwargs(cfg), device=dev, timer=timer)
    with stage(timer, "filter"):
        labels = filter_labels(ptc, pp_score, labels, **cfg.filtering.to_dict())
    with stage(timer, "box_fit"):
        fits = fit_objs_batched(calib.project_velo_to_rect(ptc[:, :3]), labels,
                                int(labels.max()), fit_method=cfg.bbox_gen.fit_method, device=dev)
        return _finish_frame(labels, fits, cfg)


def generate_masks_for_frames(frames, calibs, cfg, device="cuda",
                              timer: StageTimer | None = None):
    """``generate_mask_for_frame`` for a group of frames, with one batched
    clustering pass and one batched box-fit scan for the whole group; the
    same outputs. frames: list of (ptc (N, 4), pp_score (N,)); calibs: the
    matching list. Returns a list of (labels, objs)."""
    dev = resolve_device(device)
    _check_clustering_cfg(cfg)
    with stage(timer, "plane"):
        masks = [_frame_final_mask(ptc, cfg) for ptc, _ in frames]
    groups = dbscan_pp_many([(ptc[m, :3], pp[m]) for (ptc, pp), m in zip(frames, masks)],
                            **_dbscan_kwargs(cfg), device=dev, timer=timer)
    labels_list = []
    with stage(timer, "filter"):
        for (ptc, pp), m, sub in zip(frames, masks, groups):
            labels = np.full(ptc.shape[0], -1, dtype=np.int64)
            labels[m] = sub
            labels_list.append(filter_labels(ptc, pp, labels, **cfg.filtering.to_dict()))
    with stage(timer, "box_fit"):
        fit_groups = [(calib.project_velo_to_rect(ptc[:, :3]), lb, int(lb.max()))
                      for (ptc, _), lb, calib in zip(frames, labels_list, calibs)]
        fits = fit_objs_grouped(fit_groups, fit_method=cfg.bbox_gen.fit_method, device=dev)
        return [_finish_frame(lb, f, cfg) for lb, f in zip(labels_list, fits)]


# ---------------------------------------------------------------------------
# NMS over objs + KITTI label writing (reference pointcloud_utils.py:320-379)
# ---------------------------------------------------------------------------


def objs_to_bev_boxes(objs) -> np.ndarray:
    """objs (camera frame) → (N, 7) lidar-layout boxes for BEV IoU:
    (t_x, t_z, 0, l, w, h, -ry) — BEV overlap only sees the (x, z) footprint
    and the yaw's sign flip."""
    return np.array(
        [[o.t[0], o.t[2], 0.0, o.l, o.w, o.h, -o.ry] for o in objs], dtype=np.float32
    ).reshape(-1, 7)


def objs_nms(objs, use_score_rank=False, nms_threshold=0.1, device="cuda"):
    """Greedy BEV NMS over a frame's objects on ``device``; the kept objects
    in their original order.

    Rank: detection score, or BEV area (the reference ranks by the diagonal
    of the IoU matrix — self-IoU ≈ 1 for every box, i.e. fp noise; the
    intended area ranking is used here, reference pointcloud_utils.py:335).
    """
    if len(objs) == 0:
        return objs
    dev = resolve_device(device)
    boxes = objs_to_bev_boxes(objs)
    if use_score_rank:
        scores = np.array([o.score for o in objs], np.float32)
    else:
        scores = (boxes[:, 3] * boxes[:, 4]).astype(np.float32)
    keep_idx, keep_mask = nms_bev(torch.from_numpy(boxes)[None].to(dev),
                                  torch.from_numpy(scores)[None].to(dev), nms_threshold,
                                  max_keep=len(objs))
    keep = sorted(keep_idx[0][keep_mask[0]].tolist())
    return [objs[i] for i in keep]


def is_within_fov(obj, calib, image_shape) -> bool:
    center = np.array(obj.t, dtype=np.float64).copy()
    center[1] -= obj.h / 2
    uv = calib.project_rect_to_image(center.reshape(1, -1)).squeeze()
    return bool(
        0 <= uv[0] < image_shape[1] and 0 <= uv[1] < image_shape[0] and center[2] > 0
    )


def objs2label(objs, calib, obj_type="Dynamic", with_score=False) -> str:
    lines = []
    for obj in objs:
        alpha = -np.arctan2(obj.t[0], obj.t[2]) + obj.ry
        corners_2d = kitti_io.compute_box_3d(obj, calib.P)[0]
        min_uv = corners_2d.min(axis=0)
        max_uv = corners_2d.max(axis=0)
        score = getattr(obj, "score", -1)
        line = (
            f"{obj_type} -1 -1 {alpha:.4f} "
            f"{min_uv[0]:.4f} {min_uv[1]:.4f} {max_uv[0]:.4f} {max_uv[1]:.4f} "
            f"{obj.h:.4f} {obj.w:.4f} {obj.l:.4f} "
            f"{obj.t[0]:.4f} {obj.t[1]:.4f} {obj.t[2]:.4f} {obj.ry:.4f}"
        )
        if with_score:
            line += f" {score:.4f}"
        lines.append(line)
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# self-training label fusion (reference combine_labels.py:23-60)
# ---------------------------------------------------------------------------


def predicts2objs(preds: dict) -> list:
    objs = []
    for i in range(preds["location"].shape[0]):
        o = types.SimpleNamespace()
        o.t = preds["location"][i]
        o.l = preds["dimensions"][i][0]
        o.h = preds["dimensions"][i][1]
        o.w = preds["dimensions"][i][2]
        o.ry = preds["rotation_y"][i]
        o.score = preds["score"][i]
        objs.append(o)
    return objs


def add_area_score(objs):
    for o in objs:
        o.score = -999 + o.w * o.l


def points_in_camera_box(ptc_rect, obj) -> np.ndarray:
    """bool mask of rect-coordinate points inside a label box (bottom-centre t)."""
    shifted = ptc_rect[:, [0, 2]] - np.asarray(obj.t)[[0, 2]]
    c, s = np.cos(obj.ry), np.sin(obj.ry)
    u = shifted[:, 0] * c - shifted[:, 1] * s
    v = shifted[:, 0] * s + shifted[:, 1] * c
    return ((u > -obj.l / 2) & (u < obj.l / 2) & (v > -obj.w / 2) & (v < obj.w / 2)
            & (ptc_rect[:, 1] > obj.t[1] - obj.h) & (ptc_rect[:, 1] <= obj.t[1]))


def filter_by_ppscore(ptc_rect, pp_score, obj, percentile=50, threshold=0.5) -> bool:
    """Keep a detection iff its in-box PP percentile is low (ephemeral)."""
    mask = points_in_camera_box(ptc_rect, obj)
    if mask.sum() == 0 or np.percentile(pp_score[mask], percentile) > threshold:
        return False
    return True


def fusion_candidates(det_preds: dict, gen_objs: list, ptc_rect, pp_score, cfg) -> list:
    """The boxes a frame's fusion ranks: the detections whose in-box PP is
    low and whose score passes ``det_filtering``, then the seed boxes scored
    by area below every detection."""
    det_objs = [
        o
        for o in predicts2objs(det_preds)
        if filter_by_ppscore(
            ptc_rect, pp_score, o,
            percentile=cfg.det_filtering.pp_score_percentile,
            threshold=cfg.det_filtering.pp_score_threshold,
        )
        and o.score > cfg.det_filtering.score_filtering
    ]
    add_area_score(gen_objs)
    return det_objs + gen_objs


def combine_labels_for_frame(det_preds: dict, gen_objs: list, ptc_rect, pp_score, calib, cfg,
                             device="cuda"):
    """One frame of the self-training fusion: ``fusion_candidates``, a
    score-ranked NMS on ``device``, the optional FOV filter."""
    objs = fusion_candidates(det_preds, gen_objs, ptc_rect, pp_score, cfg)
    if len(objs) > 0:
        objs = objs_nms(objs, nms_threshold=cfg.nms.threshold, use_score_rank=True,
                        device=device)
    if cfg.fov_only:
        objs = [o for o in objs if is_within_fov(o, calib, cfg.image_shape)]
    return objs
