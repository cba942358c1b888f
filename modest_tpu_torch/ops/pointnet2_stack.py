"""Masked ball query and grouping — port of the mask-based ops of
``modest_tpu/ops/pointnet2_stack.py`` (``ball_query_masked``,
``query_and_group_masked``), which PV-RCNN's voxel set abstraction and RoI
grid pooling use.

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
