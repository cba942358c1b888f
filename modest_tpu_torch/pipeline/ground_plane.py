"""Ground-plane estimation: vectorized multi-hypothesis RANSAC.

The port's own copy of ``modest_tpu/pipeline/ground_plane.py`` (numpy, the
same RNG use, so the same planes). Fits z = a·x + b·y + c with K 3-point
hypotheses, argmax-inliers and a least-squares refit; the residual threshold
is MAD(z) like sklearn's RANSACRegressor. The plane (a, b, c, d) has a unit
normal facing down in velodyne coords: distance = p·(a,b,c) + d.
"""
from __future__ import annotations

import numpy as np


def distance_to_plane(ptc, plane, directional=False):
    d = ptc[:, :3] @ plane[:3] + plane[3]
    if not directional:
        d = np.abs(d)
    return d / np.sqrt((plane[:3] ** 2).sum())


def above_plane(ptc, plane, offset=0.05, only_range=((-30, 30), (-30, 30))):
    """True for points NOT on the ground."""
    mask = distance_to_plane(ptc, plane, directional=True) < offset
    if only_range is not None:
        range_mask = (
            (ptc[:, 0] < only_range[0][1])
            & (ptc[:, 0] > only_range[0][0])
            & (ptc[:, 1] < only_range[1][1])
            & (ptc[:, 1] > only_range[1][0])
        )
        mask &= range_mask
    return ~mask


def _ransac_plane(xy: np.ndarray, z: np.ndarray, n_trials: int, threshold: float,
                  rng: np.random.RandomState):
    """Fit z = a·x + b·y + c with vectorized 3-point RANSAC. Returns (a, b, c)."""
    n = xy.shape[0]
    idx = rng.randint(0, n, size=(n_trials, 3))
    P = np.concatenate([xy[idx], np.ones((n_trials, 3, 1))], axis=2)  # (T, 3, 3)
    Z = z[idx]  # (T, 3)

    det = np.linalg.det(P)
    ok = np.abs(det) > 1e-10
    coef = np.zeros((n_trials, 3))
    if ok.any():
        coef[ok] = np.linalg.solve(P[ok], Z[ok][:, :, None])[:, :, 0]

    A = np.concatenate([xy, np.ones((n, 1))], axis=1).astype(np.float32)  # (N, 3)
    res = np.abs(A @ coef.T.astype(np.float32) - z[:, None].astype(np.float32))
    inliers = (res <= threshold).sum(axis=0)
    inliers[~ok] = -1
    best = int(np.argmax(inliers))

    in_mask = res[:, best] <= threshold
    if in_mask.sum() >= 3:
        Ai = A[in_mask].astype(np.float64)
        zi = z[in_mask].astype(np.float64)
        try:
            coef_best = np.linalg.solve(Ai.T @ Ai, Ai.T @ zi)
        except np.linalg.LinAlgError:
            coef_best, *_ = np.linalg.lstsq(Ai, zi, rcond=None)
    else:
        coef_best = coef[best]
    return coef_best


def estimate_plane(origin_ptc: np.ndarray, max_hs: float = -1.5, it: int = 1,
                   ptc_range=((-20, 70), (-20, 20)), n_trials: int = 100,
                   seed: int = 0) -> np.ndarray:
    """Ground plane of a velodyne cloud: (4,) plane (a, b, c, d) with unit
    normal pointing down (above-ground distance < 0)."""
    rng = np.random.RandomState(seed)
    mask = (
        (origin_ptc[:, 2] < max_hs)
        & (origin_ptc[:, 0] > ptc_range[0][0])
        & (origin_ptc[:, 0] < ptc_range[0][1])
        & (origin_ptc[:, 1] > ptc_range[1][0])
        & (origin_ptc[:, 1] < ptc_range[1][1])
    )
    result = None
    for _ in range(it):
        ptc = origin_ptc[mask]
        if ptc.shape[0] < 3:
            raise ValueError("too few candidate ground points for RANSAC")
        z = ptc[:, 2]
        threshold = np.median(np.abs(z - np.median(z)))
        threshold = max(threshold, 1e-4)
        a, b, c = _ransac_plane(ptc[:, :2], z, n_trials, threshold, rng)
        w = np.array([a, b, -1.0])
        h = c
        norm = np.linalg.norm(w)
        result = -np.array([w[0], w[1], w[2], h]) / norm
        mask = ~above_plane(origin_ptc[:, :3], result, offset=0.2)
    return result
