"""Seed-label generation: PP-gated clustering → per-point seed masks and boxes.

Port of the seed-mask half of ``modest_tpu/pipeline/seed_labels.py``
(``generate_mask_for_frame(s)`` and its filters). Per frame: the
above-ground ∧ in-range mask (RANSAC ground plane), DBSCAN over the PP-gated
mutual-kNN graph on the device, the cluster validity filters, then one box
per surviving cluster, volume-filtered. Label files, NMS and label fusion
belong to the next slice.
"""
from __future__ import annotations

import numpy as np

from ..utils.device import StageTimer, resolve_device, stage
from .box_fit import fit_objs_batched, fit_objs_grouped
from .clustering import dbscan_pp, dbscan_pp_many
from .ground_plane import above_plane, distance_to_plane, estimate_plane


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
