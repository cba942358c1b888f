"""Masked ball query and grouping, and the voxel query — port of the
mask-based ops of ``modest_tpu/ops/pointnet2_stack.py``
(``ball_query_masked``, ``query_and_group_masked``), which PV-RCNN's voxel
set abstraction and RoI grid pooling use, and of ``voxel_query``, Voxel
R-CNN's neighbour lookup in the sparse backbone's sorted voxel keys.

A source set is padded to a static length and carries a validity mask
(sparse-conv voxel lists are not front-packed). Masked sources sit at
squared distance ``BIG``, so they never fall inside a ball; the first
``nsample`` in-ball sources by index fill the slots, as in
``ops/pointnet2.py::ball_query_from_dist2``; a centre with no source in its
ball groups zeros. Like the JAX package's version this is plain tensor code
(XLA there, no Pallas kernel).
"""
from __future__ import annotations

import torch

from .pointnet2 import ball_query_from_dist2, gather_points, pairwise_dist2

BIG = 1e9


@torch.no_grad()
def ball_query_masked(xyz, xyz_mask, new_xyz, radius: float, nsample: int):
    """xyz (B, N, 3), xyz_mask (B, N), new_xyz (B, M, 3) → (idx (B, M,
    nsample) int64, empty (B, M)). The (B, M, N) distance matrix is masked
    in place, and one such matrix lives at a time."""
    d2 = pairwise_dist2(new_xyz, xyz)
    d2.masked_fill_(~xyz_mask[:, None, :], BIG)
    idx, valid = ball_query_from_dist2(d2, radius, nsample)
    return idx, ~valid[..., 0]


def query_and_group_masked(xyz, xyz_mask, features, new_xyz, radius: float, nsample: int,
                           use_xyz: bool = True):
    """Group ``features`` (B, N, C) of the in-ball sources around each centre:
    (B, M, nsample, 3 + C) with the offsets to the centre first (or (B, M,
    nsample, C) without ``use_xyz``), zeros for an empty ball; and the empty
    flags (B, M)."""
    idx, empty = ball_query_masked(xyz, xyz_mask, new_xyz, radius, nsample)
    b, m, ns = idx.shape
    flat = idx.reshape(b, m * ns)
    grouped_xyz = gather_points(xyz, flat).reshape(b, m, ns, 3) - new_xyz[:, :, None, :]
    if features is not None:
        grouped_feat = gather_points(features, flat).reshape(b, m, ns, -1)
        out = torch.cat([grouped_xyz, grouped_feat], dim=-1) if use_xyz else grouped_feat
    else:
        out = grouped_xyz
    return torch.where(empty[:, :, None, None], 0.0, out), empty


VOXEL_QUERY_CHUNK = 4096  # queries per pass: a pass holds (B, chunk, (2R + 1)³) lookups


@torch.no_grad()
def voxel_query(new_xyz, voxel_keys, voxel_centers, radius: float, nsample: int,
                max_range: int, shape_zyx, point_cloud_range, voxel_size):
    """Up to ``nsample`` active voxels within ``radius`` of each query, from
    the (2R + 1)³ voxel neighbourhood (R = ``max_range``) of the query's
    cell: one ``torch.searchsorted`` of every neighbour's key into the sorted
    keys (key = (z·ny + y)·nx + x; padding keys lie past every cell), as the
    JAX package's ``voxel_query`` does.

    new_xyz (B, M, 3); voxel_keys (B, V) sorted; voxel_centers (B, V, 3);
    ``shape_zyx`` (nz, ny, nx) and ``voxel_size`` of this scale. The hits
    in the radius keep the first ``nsample`` by offset order (z outermost,
    x innermost); empty slots repeat the first hit. Returns (idx (B, M,
    nsample) int64 into V, empty (B, M): no hit, idx 0). The centres are
    gathered by each lookup's position, never broadcast to (B, M, V), and
    the queries go in chunks of ``VOXEL_QUERY_CHUNK``."""
    b, m, _ = new_xyz.shape
    v = voxel_keys.shape[1]
    nz, ny, nx = shape_zyx
    dev = new_xyz.device
    pcr = torch.tensor(point_cloud_range[:3], dtype=torch.float32, device=dev)
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    r = int(max_range)
    span = torch.arange(-r, r + 1, device=dev)
    offs = torch.stack(torch.meshgrid(span, span, span, indexing="ij"), dim=-1).reshape(-1, 3)
    dims = torch.tensor([nz, ny, nx], device=dev)
    col = torch.arange(offs.shape[0], device=dev, dtype=torch.float32)
    keys = voxel_keys.to(torch.int64).contiguous()
    idx_out, empty_out = [], []
    for lo in range(0, m, VOXEL_QUERY_CHUNK):
        q = new_xyz[:, lo:lo + VOXEL_QUERY_CHUNK]
        mq = q.shape[1]
        cell = torch.floor((q - pcr) / vs).to(torch.int64).flip(-1)  # (B, mq, 3) zyx
        cand = cell[:, :, None, :] + offs  # (B, mq, K, 3)
        inb = ((cand >= 0) & (cand < dims)).all(-1)
        ck = (cand[..., 0] * ny + cand[..., 1]) * nx + cand[..., 2]
        pos = torch.searchsorted(keys, ck.reshape(b, -1)).clamp_max(v - 1)
        hit = inb & (keys.gather(1, pos).reshape(ck.shape) == ck)
        c = voxel_centers.gather(1, pos[..., None].expand(-1, -1, 3)).reshape(*ck.shape, 3)
        d = c - q[:, :, None, :]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        hit &= d2 < radius * radius
        score = torch.where(hit, -col, float("-inf"))
        top_scores, top_off = torch.topk(score, nsample, dim=-1)  # lowest offsets first
        valid = torch.isfinite(top_scores)
        sel = pos.reshape(ck.shape).gather(2, top_off)
        any_hit = valid[..., :1]
        idx_out.append(torch.where(any_hit, torch.where(valid, sel, sel[..., :1]), 0))
        empty_out.append(~any_hit[..., 0])
    return torch.cat(idx_out, dim=1), torch.cat(empty_out, dim=1)
