"""PP-gated density clustering (DBSCAN over a mutual-kNN ∧ radius graph).

Port of ``modest_tpu/pipeline/clustering.py``. The graph: each point's k
nearest neighbours (exact, chunked ``q_sq + c_sq − 2·q·c`` distances in
float32 elementwise steps, so the card and the CPU round them alike; ties to
the lower index as ``jax.lax.top_k`` gives them), gated by mutuality
(d² ≤ kth²(j)), radius and |ΔPP| ≤ eps; DBSCAN over it labels clusters by
their smallest core index, which ``_dbscan_post`` ranks by each cluster's
first core point in the original order (sklearn's cluster ids).

The kNN stays plain PyTorch (XLA in the JAX package, not Pallas); the
edge gating and label propagation run through ``ops/dbscan.py``: the
hand-written kernels on a CUDA device, their plain twins on the CPU. Points
are x-sorted so each chunk of queries scores a window of candidates only
(exact for this graph, see ``_knn_windowed``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.dbscan import dbscan_from_knn
from ..utils.device import StageTimer, resolve_device, stage


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _bucket(n: int, row_chunk: int) -> int:
    """Quarter-power-of-two size bucket (≥ n, multiple of row_chunk)."""
    p2 = 1 << max((n - 1).bit_length(), 3)
    b = next(b for q in (4, 5, 6, 7, 8) if (b := p2 // 8 * q) >= n)
    return max(row_chunk, _round_up(b, row_chunk))


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """((a0·b0 + a1·b1) + a2·b2) of broadcastable (…, 3) tensors, one float32
    rounding per step (eager ops: no fused multiply-add on any device)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _d2(q: torch.Tensor, q_sq: torch.Tensor, c: torch.Tensor, c_sq: torch.Tensor):
    """(B, R, W) squared distances q_sq + c_sq − 2·q·c, clamped at 0."""
    cross = _dot(q[..., :, None, :], c[..., None, :, :])
    d2 = q_sq[..., :, None] + c_sq[..., None, :] - 2.0 * cross
    return torch.where(d2 > 0, d2, 0.0)


def _topk_lowest(d2: torch.Tensor, k: int):
    """k smallest of each row of a non-negative float32 (…, W) tensor, in
    (value, column) order: ties go to the lower column, as
    ``jax.lax.top_k(-d2, k)`` returns them. One int64 key per entry
    (the float bits, which order like the values, then the column)."""
    w = d2.shape[-1]
    key = (d2.view(torch.int32).long() << 32) | torch.arange(w, device=d2.device)
    top = torch.topk(key, k, dim=-1, largest=False, sorted=True).values
    return (top >> 32).to(torch.int32).view(torch.float32), (top & 0xFFFFFFFF).to(torch.int32)


def _knn(xyz: torch.Tensor, valid: torch.Tensor, k: int, row_chunk: int = 1024):
    """k nearest neighbours (excluding self) among valid points, for B
    frames: xyz (B, N, 3), valid (B, N) → idx (B, N, k) int32, d2 (B, N, k)
    float32 with inf on invalid slots."""
    n = xyz.shape[1]
    sq = _dot(xyz, xyz)
    cols = torch.arange(n, device=xyz.device)
    idx_out, d2_out = [], []
    for start in range(0, n, row_chunk):
        rows = torch.arange(start, start + row_chunk, device=xyz.device)
        d2 = _d2(xyz[:, start:start + row_chunk], sq[:, start:start + row_chunk], xyz, sq)
        d2 = torch.where((cols[None, None, :] == rows[None, :, None]) | ~valid[:, None, :],
                         torch.inf, d2)
        d2k, col = _topk_lowest(d2, k)
        idx_out.append(col)
        d2_out.append(d2k)
    return torch.cat(idx_out, dim=1), torch.cat(d2_out, dim=1)


def _knn_windowed(xyz_sorted: torch.Tensor, valid: torch.Tensor, k: int, row_chunk: int, w: int,
                  radius: float):
    """kNN over x-sorted points, B frames at once: each chunk of
    ``row_chunk`` queries scores only the ``w`` candidates starting at
    searchsorted(x, x_first − radius), clipped into [0, N − w].

    Exact for the mutual-kNN ∧ radius graph: an edge needs d ≤ r, and every
    point within r of a query lies in its window; if j's true k-th neighbour
    lies within r the window holds all k of them, and if it lies beyond r
    both the windowed and the true k-th distance exceed r²."""
    b, n, _ = xyz_sorted.shape
    xs = xyz_sorted[..., 0].contiguous()
    sq = _dot(xyz_sorted, xyz_sorted)
    starts = torch.arange(0, n, row_chunk, device=xyz_sorted.device)
    los = torch.searchsorted(xs, (xs[:, starts] - radius).contiguous()).clamp(0, n - w)
    span = torch.arange(w, device=xyz_sorted.device)
    frames = torch.arange(b, device=xyz_sorted.device)[:, None]
    kk = min(k, w)
    idx_out, d2_out = [], []
    for c, start in enumerate(range(0, n, row_chunk)):
        cand = los[:, c, None] + span                               # (B, w)
        rows = torch.arange(start, start + row_chunk, device=xyz_sorted.device)
        d2 = _d2(xyz_sorted[:, start:start + row_chunk], sq[:, start:start + row_chunk],
                 xyz_sorted[frames, cand], sq[frames, cand])
        d2 = torch.where((cand[:, None, :] == rows[None, :, None]) | ~valid[frames, cand][:, None, :],
                         torch.inf, d2)
        d2k, col = _topk_lowest(d2, kk)
        idx_out.append(col + los[:, c, None, None].to(torch.int32))
        d2_out.append(d2k)
    return torch.cat(idx_out, dim=1), torch.cat(d2_out, dim=1)


def _dbscan_prep(xyz, pp, n_pad: int, radius: float, row_chunk: int):
    """x-sort + pad one frame to n_pad rows; returns (order, x, p, valid,
    need), ``need`` the widest candidate window a chunk requires. Pad rows
    sit far away and more than a radius apart."""
    n = xyz.shape[0]
    order = np.argsort(xyz[:, 0], kind="stable")
    x = np.zeros((n_pad, 3), np.float32)
    x[:n] = xyz[order][:, :3]
    x[n:, 0] = 1e6 + np.arange(n_pad - n, dtype=np.float32) * max(4.0, 2.1 * radius)
    p = np.zeros(n_pad, np.float32)
    p[:n] = pp[order]
    valid = np.zeros(n_pad, bool)
    valid[:n] = True
    xs = x[:, 0]
    c_min = xs[0:n_pad:row_chunk]
    c_max = xs[row_chunk - 1: n_pad: row_chunk]
    need = int(np.max(np.searchsorted(xs, c_max + radius, side="right")
                      - np.searchsorted(xs, c_min - radius, side="left")))
    return order, x, p, valid, need


def _dbscan_post(raw_sorted: np.ndarray, order: np.ndarray, n: int,
                 core_sorted: np.ndarray | None = None) -> np.ndarray:
    """Raw labels (min-core indices in SORTED order) → original positions,
    compacted by each cluster's first CORE point in ORIGINAL index order."""
    raw = np.full(n, -1, np.int64)
    raw[order] = raw_sorted
    mask = raw >= 0
    out = np.full(n, -1, np.int64)
    if mask.any():
        if core_sorted is not None:
            core = np.zeros(n, bool)
            core[order] = np.asarray(core_sorted, bool)[:n]
            rank_mask = mask & core
        else:
            rank_mask = mask
        vals, first_pos = np.unique(raw[rank_mask], return_index=True)
        rank = np.empty(len(vals), np.int64)
        rank[np.argsort(first_pos, kind="stable")] = np.arange(len(vals))
        out[mask] = rank[np.searchsorted(vals, raw[mask])]
    return out


def _window_width(need: int, k: int, row_chunk: int) -> int:
    """Power-of-two candidate window covering ``need``."""
    return max(1 << (max(need, k + 1, 512) - 1).bit_length(), row_chunk)


def _prepare_group(frames, n_neighbors: int, radius: float, row_chunk: int):
    """x-sort and pad a group of frames to one size. Returns (preps, ns,
    n_pad, k, kc, w): the per-frame ``_dbscan_prep`` tuples, the frame
    sizes, the padded size, k, the kNN query chunk and the candidate window
    (``w == n_pad`` means no windowing)."""
    ns = [np.asarray(f[0]).shape[0] for f in frames]
    n_max = max(ns)
    n_pad = _bucket(n_max, row_chunk)
    # finer kNN query chunks tighten the candidate window; results do not
    # depend on the chunk (the window always covers the radius)
    kc = min(256, row_chunk)
    preps = [_dbscan_prep(np.asarray(xyz), np.asarray(pp), n_pad, radius, kc)
             for xyz, pp in frames]
    k = min(n_neighbors, max(n_max - 1, 1))
    w = min(_window_width(max(pr[4] for pr in preps), k, kc), n_pad)
    return preps, ns, n_pad, k, kc, w


def _knn_graph(preps, n_pad: int, k: int, kc: int, w: int, radius: float, dev,
               timer: StageTimer | None = None):
    """Upload a prepped group and build its kNN graph on ``dev``. Returns
    (idx (B, N, k) int32, d2 (B, N, k) float32, pp (B, N), valid (B, N))."""
    with stage(timer, "upload"):
        xb = torch.from_numpy(np.stack([pr[1] for pr in preps])).to(dev)
        pb = torch.from_numpy(np.stack([pr[2] for pr in preps])).to(dev)
        vb = torch.from_numpy(np.stack([pr[3] for pr in preps])).to(dev)
    with stage(timer, "knn"):
        if w >= n_pad:
            idx, d2 = _knn(xb, vb, k, kc)
        else:
            idx, d2 = _knn_windowed(xb, vb, k, kc, w, float(radius))
    return idx, d2, pb, vb


def dbscan_params(radius: float, eps: float) -> tuple[float, float]:
    """(radius², eps) as the float32 values the edge gate compares with."""
    return float(np.float32(radius * radius)), float(np.float32(eps))


def dbscan_pp(xyz: np.ndarray, pp: np.ndarray, *, n_neighbors: int = 70, radius: float = 2.0,
              eps: float = 0.1, min_samples: int = 10, row_chunk: int = 1024, device="cuda",
              timer: StageTimer | None = None) -> np.ndarray:
    """Cluster labels (-1 noise, 0..K-1 clusters, sklearn-compatible ids)."""
    return dbscan_pp_many([(xyz, pp)], n_neighbors=n_neighbors, radius=radius, eps=eps,
                          min_samples=min_samples, row_chunk=row_chunk, device=device,
                          timer=timer)[0]


def dbscan_pp_many(frames, *, n_neighbors: int = 70, radius: float = 2.0, eps: float = 0.1,
                   min_samples: int = 10, row_chunk: int = 1024, device="cuda",
                   timer: StageTimer | None = None) -> list:
    """Cluster a group of frames in one batched pass. frames: list of
    (xyz (n_i, 3+), pp (n_i,)) → list of label arrays, each equal to
    ``dbscan_pp`` on that frame (the shared padding and window do not change
    any frame's graph)."""
    dev = resolve_device(device)
    if not frames:
        return []
    if max(np.asarray(f[0]).shape[0] for f in frames) == 0:
        return [np.zeros(0, np.int64) for _ in frames]
    with stage(timer, "prep"):
        preps, ns, n_pad, k, kc, w = _prepare_group(frames, n_neighbors, radius, row_chunk)
    idx, d2, pb, vb = _knn_graph(preps, n_pad, k, kc, w, radius, dev, timer)
    with stage(timer, "dbscan"):
        raw, core = dbscan_from_knn(idx, d2, pb, vb, *dbscan_params(radius, eps), min_samples)
        raw, core = raw.cpu().numpy(), core.cpu().numpy()
    return [_dbscan_post(raw[i, :ns[i]], preps[i][0], ns[i], core[i, :ns[i]])
            for i in range(len(frames))]


def smooth_pp_score(ptc: np.ndarray, pp_score: np.ndarray, *, neighbor_type: str = "knn",
                    n_neighbors: int = 50, radius: float = 1.0, num_iterations: int = 10,
                    row_chunk: int = 1024, device="cuda") -> np.ndarray:
    """Graph-smooth a PP score field (reference clustering_utils.smoothing:63-93,
    dormant there): Gaussian edge weights exp(-d²/2) over the kNN graph,
    row-normalised, iterated ``num_iterations`` times on ``device``.

    ``radius`` mode keeps the k nearest within the radius (k = n_neighbors
    cap), as the JAX package does, not the reference's unbounded radius
    graph. A point with no kept neighbour keeps its own score.
    """
    dev = resolve_device(device)
    n = ptc.shape[0]
    if n == 0:
        return pp_score.copy()
    if neighbor_type not in ("knn", "radius"):
        raise NotImplementedError(neighbor_type)
    n_pad = _bucket(n, row_chunk)
    x = np.full((n_pad, 3), 1e6, np.float32)
    x[:n] = ptc[:, :3]
    x[n:, 0] += np.arange(n_pad - n, dtype=np.float32) * max(4.0, 2.1 * radius)
    p = np.zeros(n_pad, np.float32)
    p[:n] = pp_score
    valid = np.zeros(n_pad, bool)
    valid[:n] = True
    k = min(n_neighbors, max(n - 1, 1))
    valid_t = torch.from_numpy(valid).to(dev)
    idx, d2 = _knn(torch.from_numpy(x)[None].to(dev), valid_t[None], k, row_chunk=row_chunk)
    idx, d2 = idx[0].long(), d2[0]
    keep = torch.isfinite(d2)
    if neighbor_type == "radius":
        keep = keep & (d2 <= radius * radius)
    w = torch.where(keep, torch.exp(-d2 / 2.0), 0.0)
    wsum = w.sum(dim=1, keepdim=True)
    w = w / torch.clamp_min(wsum, 1e-30)
    has_nbr = valid_t & (wsum[:, 0] > 0)
    cur = torch.from_numpy(p).to(dev)
    for _ in range(num_iterations):
        cur = torch.where(has_nbr, (w * cur[idx]).sum(dim=1), cur)
    return cur[:n].cpu().numpy().astype(pp_score.dtype)
