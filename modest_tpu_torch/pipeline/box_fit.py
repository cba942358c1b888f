"""2D rectangle fitting for seed bounding boxes.

Port of ``modest_tpu/pipeline/box_fit.py``. Clusters live in rect-camera
coords; rectangles are fitted on the (x, z) plane. All fitters return
(corners (4,2), angle, area) with corner order
[(max_u, min_v), (min_u, min_v), (min_u, max_v), (max_u, max_v)] mapped back
to world, so l = u-extent and w = v-extent.

The numpy fitters are copies of the JAX package's (its CPU route). On a CUDA
device, ``fit_objs_grouped`` scores the 901 closeness angles of every
cluster of a frame group in one batched PyTorch scan
(``closeness_angles_batched``), the JAX package's off-CPU route; the box is
then assembled on the host at the best angle.
"""
from __future__ import annotations

import types

import numpy as np
import torch

from ..utils.device import resolve_device


def _proj(pts: np.ndarray, angles: np.ndarray):
    """Project (n,2) pts into frames rotated by each angle → (A, n, 2)."""
    c, s = np.cos(angles), np.sin(angles)
    u = pts[None, :, 0] * c[:, None] + pts[None, :, 1] * s[:, None]
    v = -pts[None, :, 0] * s[:, None] + pts[None, :, 1] * c[:, None]
    return u, v


def _corners_world(angle: float, min_u, max_u, min_v, max_v):
    c, s = np.cos(angle), np.sin(angle)
    comp = np.array([[c, s], [-s, c]])
    rect = np.array([[max_u, min_v], [min_u, min_v], [min_u, max_v], [max_u, max_v]])
    return rect @ comp


def _finalize(pts: np.ndarray, angle: float):
    """Recompute the box at `angle`, flipping by 90° so l >= w (reference
    closeness/variance tail: :197-216)."""
    u, v = _proj(pts, np.array([angle]))
    u, v = u[0], v[0]
    if (u.max() - u.min()) < (v.max() - v.min()):
        angle = angle + np.pi / 2
        u, v = _proj(pts, np.array([angle]))
        u, v = u[0], v[0]
    min_u, max_u, min_v, max_v = u.min(), u.max(), v.min(), v.max()
    area = (max_u - min_u) * (max_v - min_v)
    return _corners_world(angle, min_u, max_u, min_v, max_v), angle, area


def closeness_rectangle(cluster_ptc: np.ndarray, delta=0.1, d0=1e-2):
    """Closeness-to-edge scoring over a 0..90° angle scan (reference :167-216)."""
    angles = np.arange(0, 90 + delta, delta) / 180.0 * np.pi
    u, v = _proj(cluster_ptc, angles)  # (A, n)
    du = np.minimum(u - u.min(1, keepdims=True), u.max(1, keepdims=True) - u)
    dv = np.minimum(v - v.min(1, keepdims=True), v.max(1, keepdims=True) - v)
    beta = np.maximum(np.minimum(du, dv), d0)
    score = (1.0 / beta).sum(1)
    return _finalize(cluster_ptc, angles[int(np.argmax(score))])


def variance_rectangle(cluster_ptc: np.ndarray, delta=0.1):
    """Variance-to-edge scoring (reference :219-275)."""
    angles = np.arange(0, 90 + delta, delta) / 180.0 * np.pi
    u, v = _proj(cluster_ptc, angles)
    du = np.minimum(u - u.min(1, keepdims=True), u.max(1, keepdims=True) - u)
    dv = np.minimum(v - v.min(1, keepdims=True), v.max(1, keepdims=True) - v)
    mask_u = du < dv  # point assigned to a u-edge
    mask_v = dv < du

    def masked_var(d, m):
        cnt = m.sum(1)
        safe = np.maximum(cnt, 1)
        mean = (d * m).sum(1) / safe
        var = ((d - mean[:, None]) ** 2 * m).sum(1) / safe
        return np.where(cnt > 0, -var, 0.0)

    score = masked_var(du, mask_u) + masked_var(dv, mask_v)
    return _finalize(cluster_ptc, angles[int(np.argmax(score))])


def PCA_rectangle(cluster_ptc: np.ndarray):
    """Principal-axis aligned rectangle (reference :149-165)."""
    centered = cluster_ptc - cluster_ptc.mean(0)
    cov = centered.T @ centered
    _, vecs = np.linalg.eigh(cov)
    first = vecs[:, -1]  # principal component
    angle = np.arctan2(first[1], first[0])
    comp = np.array([[np.cos(angle), np.sin(angle)], [-np.sin(angle), np.cos(angle)]])
    on = cluster_ptc @ comp.T
    min_u, max_u = on[:, 0].min(), on[:, 0].max()
    min_v, max_v = on[:, 1].min(), on[:, 1].max()
    area = (max_u - min_u) * (max_v - min_v)
    return _corners_world(angle, min_u, max_u, min_v, max_v), angle, area


def minimum_bounding_rectangle(cluster_ptc: np.ndarray):
    """Exact min-area rectangle via convex-hull edge directions (:88-147)."""
    from scipy.spatial import ConvexHull

    hull = cluster_ptc[ConvexHull(cluster_ptc).vertices]
    # the reference scans consecutive hull edges only (no closing edge,
    # pointcloud_utils.py:104-105) — follow it exactly for label parity
    edges = np.diff(hull, axis=0)
    angles = np.unique(np.abs(np.mod(np.arctan2(edges[:, 1], edges[:, 0]), np.pi / 2)))
    u, v = _proj(hull, angles)
    areas = (u.max(1) - u.min(1)) * (v.max(1) - v.min(1))
    best = int(np.argmin(areas))
    angle = angles[best]
    min_u, max_u = u[best].min(), u[best].max()
    min_v, max_v = v[best].min(), v[best].max()
    return _corners_world(angle, min_u, max_u, min_v, max_v), angle, areas[best]


FIT_METHODS = {
    "closeness_to_edge": closeness_rectangle,
    "variance_to_edge": variance_rectangle,
    "PCA": PCA_rectangle,
    "min_zx_area_fit": minimum_bounding_rectangle,
}


class FrameBins:
    """2-D (x, z) bin index over a frame's points for box-local queries.

    get_lowest_point_rect scans the FULL cloud once per cluster (K × N host
    ops per frame). One bin sort per frame + per-cluster gathers of only the bins overlapping
    the box AABB replaces that with O(N log N + K × box_pts), bit-identical
    results (the exact in-rect mask is re-evaluated on the candidates; the
    AABB cover guarantees no in-rect point is outside them).
    """

    def __init__(self, pts_xz: np.ndarray, bin_size: float = 4.0):
        self.bin_size = float(bin_size)
        bx = np.floor(pts_xz[:, 0] / self.bin_size).astype(np.int64)
        bz = np.floor(pts_xz[:, 1] / self.bin_size).astype(np.int64)
        self.x0 = int(bx.min()) if len(bx) else 0
        self.z0 = int(bz.min()) if len(bz) else 0
        self.nx = int(bx.max()) - self.x0 + 1 if len(bx) else 1
        self.nz = int(bz.max()) - self.z0 + 1 if len(bz) else 1
        bid = (bx - self.x0) * self.nz + (bz - self.z0)
        self.order = np.argsort(bid, kind="stable")
        self.sorted_bid = bid[self.order]

    def query_aabb(self, xlo, xhi, zlo, zhi) -> np.ndarray:
        """Indices (original order not preserved) of all points whose bin
        intersects the axis-aligned box [xlo, xhi] × [zlo, zhi]."""
        bs = self.bin_size
        bx_lo = max(int(np.floor(xlo / bs)) - self.x0, 0)
        bx_hi = min(int(np.floor(xhi / bs)) - self.x0, self.nx - 1)
        bz_lo = max(int(np.floor(zlo / bs)) - self.z0, 0)
        bz_hi = min(int(np.floor(zhi / bs)) - self.z0, self.nz - 1)
        if bx_lo > bx_hi or bz_lo > bz_hi:
            return np.empty(0, np.int64)
        rows = np.arange(bx_lo, bx_hi + 1, dtype=np.int64) * self.nz
        lo = np.searchsorted(self.sorted_bid, rows + bz_lo, side="left")
        hi = np.searchsorted(self.sorted_bid, rows + bz_hi, side="right")
        if len(rows) == 1:
            return self.order[lo[0] : hi[0]]
        return np.concatenate(
            [self.order[a:b] for a, b in zip(lo, hi) if b > a]
            or [np.empty(0, np.int64)]
        )


def lowest_point_rect_binned(full_rect: np.ndarray, bins: FrameBins, full_max_y: float,
                             xz_center, l, w, ry) -> float:
    """get_lowest_point_rect via the frame's bin index — identical result."""
    c, s = np.cos(ry), np.sin(ry)
    hx = (abs(c) * l + abs(s) * w) / 2
    hz = (abs(s) * l + abs(c) * w) / 2
    idx = bins.query_aabb(xz_center[0] - hx, xz_center[0] + hx,
                          xz_center[1] - hz, xz_center[1] + hz)
    if idx.size == 0:
        return full_max_y
    sub = full_rect[idx]
    u = (sub[:, 0] - xz_center[0]) * c - (sub[:, 2] - xz_center[1]) * s
    v = (sub[:, 0] - xz_center[0]) * s + (sub[:, 2] - xz_center[1]) * c
    mask = (u > -l / 2) & (u < l / 2) & (v > -w / 2) & (v < w / 2)
    ys = sub[mask, 1]
    return float(ys.max()) if ys.size else full_max_y


def cluster_segments(labels: np.ndarray, n_clusters: int):
    """One stable sort → per-cluster index arrays (original point order).

    Replaces K boolean `labels == i` passes over the full frame (K × N host
    ops) with one argsort + K slice-gathers. Returns {i: indices} for
    i = 1..n_clusters (empty clusters omitted).
    """
    order = np.argsort(labels, kind="stable")
    sorted_lab = labels[order]
    bounds = np.searchsorted(sorted_lab, np.arange(1, n_clusters + 2))
    return {
        i: order[bounds[i - 1] : bounds[i]]
        for i in range(1, n_clusters + 1)
        if bounds[i] > bounds[i - 1]
    }


def get_lowest_point_rect(ptc: np.ndarray, xz_center, l, w, ry) -> float:
    """Max y (lowest point, camera coords) of the full cloud inside the
    fitted BEV rectangle (reference :278-290)."""
    shifted = ptc[:, [0, 2]] - xz_center
    c, s = np.cos(ry), np.sin(ry)
    u = shifted[:, 0] * c - shifted[:, 1] * s
    v = shifted[:, 0] * s + shifted[:, 1] * c
    mask = (u > -l / 2) & (u < l / 2) & (v > -w / 2) & (v < w / 2)
    ys = ptc[mask, 1]
    return float(ys.max()) if ys.size else float(ptc[:, 1].max())


def get_obj(cluster_rect: np.ndarray, full_rect: np.ndarray,
            fit_method: str = "closeness_to_edge") -> types.SimpleNamespace:
    """Fit a camera-frame box to a cluster (reference get_obj:292-317).

    cluster_rect / full_rect: (n, 3) points in rect camera coords.
    Returns obj with t (bottom center), l, w, h, ry, volume.
    """
    fitter = FIT_METHODS[fit_method]
    corners, ry, area = fitter(cluster_rect[:, [0, 2]])
    ry = -ry
    l = float(np.linalg.norm(corners[0] - corners[1]))
    w = float(np.linalg.norm(corners[0] - corners[-1]))
    c = (corners[0] + corners[2]) / 2
    bottom = get_lowest_point_rect(full_rect, c, l, w, ry)
    h = float(bottom - cluster_rect[:, 1].min())
    obj = types.SimpleNamespace()
    obj.t = np.array([c[0], bottom, c[1]])
    obj.l = l
    obj.w = w
    obj.h = h
    obj.ry = float(ry)
    obj.volume = float(area * h)
    return obj


# ---------------------------------------------------------------------------
# batched closeness scan on the device
# ---------------------------------------------------------------------------

_SCAN_ELEMENTS = 1 << 25  # clusters × padded points × angles per scan chunk


def closeness_angles_batched(clusters, delta=0.1, d0=1e-2, device="cuda"):
    """Best closeness angle per cluster. clusters: list of (n_i, 2) arrays
    → list of angles (floats). Each cluster's (x, z) points are projected on
    all 901 angles at once (u = x·cos + z·sin, v = z·cos − x·sin, float32
    elementwise steps), scored by Σ 1/max(min(du, dv), d0) over its points,
    and the first best angle wins."""
    dev = resolve_device(device)
    angles = np.arange(0, 90 + delta, delta) / 180.0 * np.pi
    cs = torch.from_numpy(np.stack([np.cos(angles), np.sin(angles)]).astype(np.float32)).to(dev)
    cos, sin = cs[0], cs[1]
    n_angles = len(angles)
    out = []
    p_pad = max(256, 1 << (max(cl.shape[0] for cl in clusters) - 1).bit_length())
    step = max(1, _SCAN_ELEMENTS // (p_pad * n_angles))
    for c0 in range(0, len(clusters), step):
        chunk = clusters[c0:c0 + step]
        pts = np.zeros((len(chunk), p_pad, 2), np.float32)
        mask = np.zeros((len(chunk), p_pad), bool)
        for i, cl in enumerate(chunk):
            pts[i, : cl.shape[0]] = cl
            mask[i, : cl.shape[0]] = True
        p = torch.from_numpy(pts).to(dev)
        m = torch.from_numpy(mask).to(dev)[..., None]              # (C, P, 1)
        x, z = p[..., 0, None], p[..., 1, None]                    # (C, P, 1)
        u = x * cos + z * sin                                      # (C, P, A)
        v = z * cos - x * sin
        big = torch.tensor(1e9, dtype=torch.float32, device=dev)
        u_min = torch.where(m, u, big).amin(dim=1, keepdim=True)
        u_max = torch.where(m, u, -big).amax(dim=1, keepdim=True)
        v_min = torch.where(m, v, big).amin(dim=1, keepdim=True)
        v_max = torch.where(m, v, -big).amax(dim=1, keepdim=True)
        du = torch.minimum(u - u_min, u_max - u)
        dv = torch.minimum(v - v_min, v_max - v)
        beta = torch.clamp_min(torch.minimum(du, dv), d0)
        scores = torch.where(m, 1.0 / beta, 0.0).sum(dim=1)        # (C, A)
        out += [float(angles[i]) for i in torch.argmax(scores, dim=1).cpu().tolist()]
    return out


def _obj_from_angle(cl2d, angle, cluster_rect, full_rect, bins=None, full_max_y=None):
    """Assemble the camera-frame box at a fixed scan angle (get_obj tail)."""
    corners, ry, area = _finalize(cl2d, angle)
    ry = -ry
    l = float(np.linalg.norm(corners[0] - corners[1]))
    w = float(np.linalg.norm(corners[0] - corners[-1]))
    c = (corners[0] + corners[2]) / 2
    if bins is not None:
        bottom = lowest_point_rect_binned(full_rect, bins, full_max_y, c, l, w, ry)
    else:
        bottom = get_lowest_point_rect(full_rect, c, l, w, ry)
    h = float(bottom - cluster_rect[:, 1].min())
    return types.SimpleNamespace(t=np.array([c[0], bottom, c[1]]), l=l, w=w, h=h, ry=float(ry),
                                 volume=float(area * h))


def fit_objs_batched(ptc_rect, labels, n_clusters, fit_method="closeness_to_edge", delta=0.1,
                     d0=1e-2, device="cuda"):
    """Fit all clusters of a frame. Returns list of (cluster_id, obj)."""
    return fit_objs_grouped([(ptc_rect, labels, n_clusters)], fit_method, delta, d0, device)[0]


def fit_objs_grouped(groups, fit_method="closeness_to_edge", delta=0.1, d0=1e-2, device="cuda"):
    """Fit the clusters of a group of frames; on a CUDA device one batched
    angle scan for all of them, on the CPU the numpy ``get_obj`` per cluster.

    groups: list of (ptc_rect, labels, n_clusters) → list of [(id, obj)]."""
    dev = resolve_device(device)
    seg_per_group = [cluster_segments(labels, n_clusters) for (_p, labels, n_clusters) in groups]
    metas = []  # (group index, cluster id, (n_i, 2) points, (n_i, 3) rect points)
    for g, (ptc_rect, _labels, _n) in enumerate(groups):
        for i, idx in seg_per_group[g].items():
            sub = ptc_rect[idx]
            metas.append((g, i, sub[:, [0, 2]], sub))
    out = [[] for _ in groups]
    if not metas:
        return out
    if fit_method != "closeness_to_edge" or dev.type == "cpu":
        for g, i, _cl, sub in metas:
            out[g].append((i, get_obj(sub, groups[g][0], fit_method)))
        return out
    bins_per_group = [FrameBins(p[:, [0, 2]]) for p, _l, _n in groups]
    maxy_per_group = [float(p[:, 1].max()) if len(p) else 0.0 for p, _l, _n in groups]
    angles = closeness_angles_batched([c for _, _, c, _ in metas], delta, d0, dev)
    for (g, i, cl, sub), angle in zip(metas, angles):
        out[g].append((i, _obj_from_angle(cl, angle, sub, groups[g][0], bins=bins_per_group[g],
                                          full_max_y=maxy_per_group[g])))
    return out
