"""PointNet++ point ops — port of ``modest_tpu/ops/pointnet2.py``, exact mode.

The JAX package's exact mode (``MODEST_EXACT_OPS=1``) is the target: FPS,
first-by-index ball query with the reference fill rules, the exact 3-pass
three-NN and f32 gathers everywhere. Its TPU-only variants (approximate
top-k, nearest-k grouping, windowed kNN, one-hot and bf16 gathers, compact
or windowed RoI pooling) are not ported.

Layouts are channel-last as in JAX: points (B, N, 3), features (B, N, C).
Index outputs are int64, which ``torch.gather`` takes directly; the FPS
kernel's int32 indices are widened where they are used.
"""
from __future__ import annotations

import torch

from .fps import furthest_point_sample_cuda, furthest_point_sample_plain


def _sq_norm(a):
    """(..., 3) → (...,) as ((a0² + a1²) + a2²), the JAX summation order."""
    return a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1] + a[..., 2] * a[..., 2]


def pairwise_dist2(a, b):
    """(..., N, 3), (..., M, 3) → (..., N, M) squared distances.

    |a|² + |b|² − 2ab clamped at 0, the JAX form: ball-query membership at
    d² ≈ r² is decided by the same rounding as there."""
    cross = torch.matmul(a, b.transpose(-1, -2))
    return torch.clamp_min(_sq_norm(a)[..., :, None] + _sq_norm(b)[..., None, :] - 2.0 * cross, 0.0)


def nearest_topk(d2, k: int):
    """(…, N) non-negative squared distances → (top_d2, top_idx int64) of
    the k nearest, ascending, ties to the lower index: JAX's exact form,
    ``lax.top_k(-d2, k)``. ``torch.topk`` leaves the order of ties open, so
    it ranks one int64 key per entry, the float bits (which order like the
    values) then the column."""
    n = d2.shape[-1]
    key = (d2.view(torch.int32).long() << 32) | torch.arange(n, device=d2.device)
    top = torch.topk(key, min(k, n), dim=-1, largest=False, sorted=True).values
    return (top >> 32).to(torch.int32).view(torch.float32), top & 0xFFFFFFFF


def furthest_point_sample(xyz, npoint: int):
    """(B, N, 3) → (B, npoint) int32 indices.

    A CUDA tensor goes to the hand-written kernel, a CPU tensor to its plain
    version; there is no fallback between the two."""
    if xyz.is_cuda:
        return furthest_point_sample_cuda(xyz.contiguous(), npoint)
    if xyz.device.type == "cpu":
        return furthest_point_sample_plain(xyz, npoint)
    raise ValueError(f"furthest_point_sample: unsupported device {xyz.device}")


def gather_points(points, idx):
    """(B, N, C), (B, M) → (B, M, C)."""
    idx = idx.long()
    return torch.gather(points, 1, idx[..., None].expand(-1, -1, points.shape[-1]))


def ball_query_from_dist2(d2, radius: float, nsample: int):
    """d2 (..., M, N) → (idx (..., M, nsample) int64, valid (..., M, nsample)).

    Strict d² < r²; the first ``nsample`` in-ball points in index order; the
    first hit fills the unfilled slots; an empty ball gives index 0."""
    n = d2.shape[-1]
    in_ball = d2 < radius * radius
    col = torch.arange(n, device=d2.device, dtype=torch.float32)
    # rank by index: a hit scores -index (larger = earlier), a miss -inf.
    # torch.topk orders ties arbitrarily, but the only ties are among -inf
    # misses, and those slots are replaced by the first hit below.
    score = torch.where(in_ball, -col, torch.tensor(float("-inf"), device=d2.device))
    top_scores, top_idx = torch.topk(score, min(nsample, n), dim=-1, sorted=True)
    del score
    if nsample > n:  # fewer source points than samples: wrap-fill
        reps = -(-nsample // n)
        top_scores = torch.cat([top_scores] * reps, -1)[..., :nsample]
        top_idx = torch.cat([top_idx] * reps, -1)[..., :nsample]
    valid = torch.isfinite(top_scores)
    first = top_idx[..., 0:1]
    any_hit = valid[..., 0:1]
    filled = torch.where(valid, top_idx, first)
    return torch.where(any_hit, filled, torch.zeros_like(filled)), valid & any_hit


def query_and_group(xyz, new_xyz, features, d2, radius: float, nsample: int):
    """Group around centers (reference QueryAndGroup, use_xyz=True).

    xyz (B, N, 3); new_xyz (B, M, 3); features (B, N, C) or None; d2
    (B, M, N). Returns (B, M, nsample, 3+C), or (B, M, nsample, 3)
    without features."""
    idx, _ = ball_query_from_dist2(d2, radius, nsample)
    b, m, ns = idx.shape
    flat = idx.reshape(b, m * ns)
    grouped_xyz = gather_points(xyz, flat).reshape(b, m, ns, 3) - new_xyz[:, :, None, :]
    if features is None:
        return grouped_xyz
    grouped_feat = gather_points(features, flat).reshape(b, m, ns, features.shape[-1])
    return torch.cat([grouped_xyz, grouped_feat], dim=-1)


def group_all(xyz, features):
    """(B, N, 3), (B, N, C) → (B, 1, N, 3+C) (reference GroupAll, use_xyz=True)."""
    grouped = xyz[:, None, :, :]
    if features is None:
        return grouped
    return torch.cat([grouped, features[:, None, :, :]], dim=-1)


def three_nn(unknown, known):
    """(B, n, 3), (B, m, 3) → (dist (B, n, 3), idx (B, n, 3) int64).

    Exact 3-pass argmin over the matmul distances (argmin takes the first
    minimum, as in JAX), then the winners' distances recomputed elementwise
    so exact zeros survive. The distance matrix is overwritten in place."""
    d2 = pairwise_dist2(unknown, known)
    idxs = []
    for k in range(3):
        i = torch.argmin(d2, dim=-1)
        idxs.append(i)
        if k < 2:
            d2.scatter_(-1, i[..., None], float("inf"))
    del d2
    idx = torch.stack(idxs, dim=-1)
    b, n, _ = idx.shape
    nbr = gather_points(known, idx.reshape(b, -1)).reshape(b, n, 3, 3)
    return torch.sqrt(_sq_norm(nbr - unknown[:, :, None, :])), idx


def three_interpolate(features, idx, weight):
    """(B, m, C), (B, n, 3), (B, n, 3) → (B, n, C)."""
    b, n, _ = idx.shape
    gathered = gather_points(features, idx.reshape(b, -1)).reshape(b, n, 3, -1)
    return (gathered * weight[..., None]).sum(dim=2)


def interpolate_features(unknown, known, known_feats):
    """Full FP interpolation step (reference PointnetFPModule)."""
    dist, idx = three_nn(unknown, known)
    dist_recip = 1.0 / (dist + 1e-8)
    weight = dist_recip / dist_recip.sum(-1, keepdim=True)
    return three_interpolate(known_feats, idx, weight)


def roipoint_pool3d(points, point_features, boxes3d, num_sampled_points: int = 512,
                    pool_extra_width=(0.0, 0.0, 0.0)):
    """Pool raw points + features inside (enlarged) RoIs.

    points (B, N, 3); point_features (B, N, C); boxes3d (B, R, 7). Returns
    pooled (B, R, num_sampled_points, 3+C) and empty_flag (B, R) int32. The
    first in-box points in index order fill the slots, a short box wraps
    around from its first point, and an empty box is flagged."""
    ex = torch.as_tensor(pool_extra_width, dtype=boxes3d.dtype, device=boxes3d.device)
    big = torch.cat([boxes3d[..., 0:3], boxes3d[..., 3:6] + ex, boxes3d[..., 6:]], dim=-1)
    b, n, _ = points.shape
    shift = points[:, None, :, :] - big[:, :, None, 0:3]  # (B, R, N, 3)
    ang = -big[..., 6]
    c, s = torch.cos(ang)[..., None], torch.sin(ang)[..., None]
    lx = shift[..., 0] * c - shift[..., 1] * s
    ly = shift[..., 0] * s + shift[..., 1] * c
    in_box = ((shift[..., 2].abs() <= big[..., 5:6] / 2)
              & (lx.abs() <= big[..., 3:4] / 2)
              & (ly.abs() <= big[..., 4:5] / 2))
    del shift, lx, ly
    col = torch.arange(n, device=points.device, dtype=torch.float32)
    # index-rank top-k = the first k in-box points; the order of the -inf
    # ties does not matter: slots past the in-box count are wrap-filled, and
    # an empty box pools point 0 (what lax.top_k's index order gives in JAX)
    score = torch.where(in_box, -col, torch.tensor(float("-inf"), device=points.device))
    top_scores, top_idx = torch.topk(score, num_sampled_points, dim=-1, sorted=True)
    cnt = torch.isfinite(top_scores).sum(-1)  # (B, R)
    slot = torch.arange(num_sampled_points, device=points.device)
    src = slot % cnt.clamp_min(1)[..., None]
    sel = torch.where(cnt[..., None] > 0, torch.gather(top_idx, -1, src), 0)  # (B, R, K)
    r = boxes3d.shape[1]
    flat = sel.reshape(b, r * num_sampled_points)
    pooled = torch.cat([gather_points(points, flat), gather_points(point_features, flat)], dim=-1)
    return pooled.reshape(b, r, num_sampled_points, -1), (cnt == 0).to(torch.int32)
