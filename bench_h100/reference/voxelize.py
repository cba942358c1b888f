# Frozen copy of modest_tpu_torch/models/voxelize.py, the benchmark's plain reference: it
# imports nothing of the port and changes only when the benchmark is redefined.
"""Voxelization on the device — port of ``modest_tpu/models/voxelize.py``
(reference data_processor.transform_points_to_voxels).

Batched tensor functions over padded point tensors (B, N, C); nothing
voxelizes on the host. Two paths, as in the JAX package:

* pillars: per-point features scattered straight into the dense BEV grid by
  a segment max, so every point of a pillar counts;
* sparse voxels (SECOND): the sorted unique active voxels of each scan,
  padded to a cap, with per-voxel mean features, for the gather-scatter
  sparse convolution (``models/sparse_conv.py``).

Keys and coordinates are int64. The sums (``pillar_stats``, the voxel means)
use ``index_add_``, which on the card adds in atomic order: their float sums
may differ from the CPU's in the last bits, the keys and coordinates may not.
"""
from __future__ import annotations

import torch


def point_voxel_coords(points, point_cloud_range, voxel_size, grid_size):
    """points (..., 3+) → int64 voxel coords (..., 3) in (x, y, z) order, and
    valid (...,): inside the grid and inside the range."""
    pcr = torch.tensor(point_cloud_range, dtype=points.dtype, device=points.device)
    vs = torch.tensor(voxel_size, dtype=points.dtype, device=points.device)
    xyz = points[..., :3]
    coords = torch.floor((xyz - pcr[:3]) / vs)
    gs = torch.tensor(grid_size, dtype=points.dtype, device=points.device)
    valid = ((coords >= 0) & (coords < gs)).all(-1)
    # the raw point inside the range too (guards float edge cases)
    valid &= ((xyz >= pcr[:3]) & (xyz < pcr[3:6])).all(-1)
    coords = torch.where(valid[..., None], coords, torch.zeros_like(coords))
    return coords.to(torch.int64), valid


def _batch_offsets(key, cells: int):
    """(B, N) per-scan cell keys → keys into one flat (B · cells) table."""
    b = key.shape[0]
    return key + cells * torch.arange(b, device=key.device)[:, None]


def pillar_stats(points, valid, coords_xy, nx: int, ny: int):
    """Per-pillar point count and xyz mean, gathered back to the points.

    points (B, N, 3+); valid (B, N); coords_xy (B, N, 2). Returns (count
    (B, N), mean (B, N, 3), flat pillar key (B, N)); invalid points carry the
    key nx·ny and garbage stats."""
    key = torch.where(valid, coords_xy[..., 1] * nx + coords_xy[..., 0], nx * ny)
    cells = nx * ny + 1
    flat = _batch_offsets(key, cells).reshape(-1)
    ones = valid.to(points.dtype).reshape(-1)
    b = points.shape[0]
    cnt = torch.zeros(b * cells, dtype=points.dtype, device=points.device).index_add_(
        0, flat, ones)
    sums = torch.zeros(b * cells, 3, dtype=points.dtype, device=points.device).index_add_(
        0, flat, points[..., :3].reshape(-1, 3) * ones[:, None])
    count = cnt[flat]
    mean = sums[flat] / torch.clamp_min(count, 1.0)[:, None]
    return count.reshape(key.shape), mean.reshape(*key.shape, 3), key


def scatter_max_bev(features, key, valid, nx: int, ny: int):
    """(B, N, C) per-point features → dense (B, C, ny, nx) BEV by a segment
    max, channels first for the 2-D backbone. Empty cells are 0: the features
    are post-ReLU (≥ 0), as the reference's zero-initialised scatter."""
    b, n, c = features.shape
    cells = nx * ny + 1
    key = torch.where(valid, key, nx * ny)
    src = torch.where(valid[..., None], features, 0.0).transpose(1, 2)  # (B, C, N)
    grid = torch.zeros(b, c, cells, dtype=features.dtype, device=features.device)
    grid = grid.scatter_reduce(2, key[:, None, :].expand(b, c, n), src, reduce="amax",
                               include_self=True)
    return grid[..., :nx * ny].reshape(b, c, ny, nx)


def _unique_sorted(keys, big: int, cap: int):
    """Per row of (B, K) keys: the unique keys below ``big`` in ascending
    order, the first ``cap`` of them, padded with ``big`` → (B, cap)."""
    sk = torch.sort(keys, dim=1).values
    first = torch.ones_like(sk, dtype=torch.bool)
    first[:, 1:] = sk[:, 1:] != sk[:, :-1]
    first &= sk < big
    rank = torch.cumsum(first, dim=1) - 1
    slot = torch.where(first & (rank < cap), rank, cap)  # the rest drop
    out = torch.full((keys.shape[0], cap + 1), big, dtype=keys.dtype, device=keys.device)
    return out.scatter(1, slot, sk)[:, :cap].contiguous()


def key_to_zyx(keys, ny: int, nx: int):
    return torch.stack([keys // (ny * nx), (keys // nx) % ny, keys % nx], dim=-1)


def voxelize_sparse(points, valid, coords, max_voxels: int, nx: int, ny: int, nz: int):
    """Active-voxel extraction, batched.

    points (B, N, C); valid (B, N); coords (B, N, 3) int (x, y, z). Each scan
    keeps its ``max_voxels`` unique voxels of lowest flat key z·ny·nx + y·nx
    + x (the JAX package's truncation). Returns
      voxel_coords (B, max_voxels, 3) int64 in (z, y, x) order,
      voxel_feats (B, max_voxels, C), the mean of the voxel's points,
      voxel_valid (B, max_voxels) bool,
      voxel_keys (B, max_voxels) sorted int64 flat keys (nx·ny·nz pads).
    """
    big = nx * ny * nz
    key = torch.where(valid, coords[..., 2] * ny * nx + coords[..., 1] * nx + coords[..., 0],
                      big)
    voxel_keys = _unique_sorted(key, big, max_voxels)
    voxel_valid = voxel_keys < big
    voxel_coords = key_to_zyx(voxel_keys, ny, nx)

    # mean features per voxel: points of a voxel beyond the cap drop
    slot = torch.searchsorted(voxel_keys, key)
    hit = torch.gather(voxel_keys, 1, slot.clamp_max(max_voxels - 1)) == key
    in_kept = valid & (slot < max_voxels) & hit
    slot = torch.where(in_kept, slot, max_voxels)
    b, n, c = points.shape
    flat = _batch_offsets(slot, max_voxels + 1).reshape(-1)
    w = in_kept.to(points.dtype).reshape(-1)
    sums = torch.zeros(b * (max_voxels + 1), c, dtype=points.dtype,
                       device=points.device).index_add_(
        0, flat, torch.where(in_kept[..., None], points, 0.0).reshape(-1, c))
    cnts = torch.zeros(b * (max_voxels + 1), dtype=points.dtype,
                       device=points.device).index_add_(0, flat, w)
    sums = sums.reshape(b, max_voxels + 1, c)[:, :max_voxels]
    cnts = cnts.reshape(b, max_voxels + 1)[:, :max_voxels]
    feats = sums / torch.clamp_min(cnts, 1.0)[..., None]
    return voxel_coords, feats, voxel_valid, voxel_keys


def voxel_counts(points, point_cloud_range, voxel_size, grid_size, max_voxels: int):
    """Per scan of (B, N, 3+) points: (in-range points, occupied voxels, kept
    voxels, points dropped by the ``max_voxels`` cap), each (B,) int64."""
    nx, ny, nz = (int(v) for v in grid_size)
    coords, valid = point_voxel_coords(points, point_cloud_range, voxel_size, grid_size)
    big = nx * ny * nz
    key = torch.where(valid, coords[..., 2] * ny * nx + coords[..., 1] * nx + coords[..., 0],
                      big)
    n = key.shape[1]
    occupied = _unique_sorted(key, big, n) < big
    kept = _unique_sorted(key, big, max_voxels)
    slot = torch.searchsorted(kept, key).clamp_max(max_voxels - 1)
    in_kept = valid & (torch.gather(kept, 1, slot) == key)
    return valid.sum(1), occupied.sum(1), (kept < big).sum(1), (valid & ~in_kept).sum(1)
