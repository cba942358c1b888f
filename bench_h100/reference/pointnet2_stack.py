"""The masked ball query and grouping of PV-RCNN's voxel set abstraction and
RoI-grid pooling, in plain PyTorch: the arithmetic of the port's
``ops/pointnet2_stack.py::ball_query_masked`` and ``query_and_group_masked``
on this reference's ``pointnet2.py``, with the centres taken in blocks.

A source set is padded to a static length and carries a validity mask;
masked sources sit at squared distance ``BIG``, so they never fall inside a
ball; the first ``nsample`` in-ball sources by index fill the slots
(``pointnet2.py::ball_query_from_dist2``); a centre with no source in its
ball groups zeros. Each centre's row of the distance matrix depends on that
centre alone, so the centres go in blocks of at most ``BLOCK_ENTRIES //
(B·N)``: the reference holds a (B, block, N) matrix where the port holds
(B, M, N), and fits on the card beside it.
"""
from __future__ import annotations

import torch

from .pointnet2 import ball_query_from_dist2, gather_points, pairwise_dist2

BIG = 1e9
BLOCK_ENTRIES = 2 ** 26  # distances held at once: 256 MB of float32


@torch.no_grad()
def ball_query_masked(xyz, xyz_mask, new_xyz, radius: float, nsample: int):
    """xyz (B, N, 3), xyz_mask (B, N), new_xyz (B, M, 3) → (idx (B, M,
    nsample) int64, empty (B, M))."""
    b, n = xyz.shape[0], xyz.shape[1]
    step = max(1, BLOCK_ENTRIES // (b * n))
    idx, empty = [], []
    for lo in range(0, new_xyz.shape[1], step):
        d2 = pairwise_dist2(new_xyz[:, lo:lo + step], xyz)
        d2 = torch.where(xyz_mask[:, None, :], d2, BIG)
        i, valid = ball_query_from_dist2(d2, radius, nsample)
        idx.append(i)
        empty.append(~valid[..., 0])
    return torch.cat(idx, dim=1), torch.cat(empty, dim=1)


def query_and_group_masked(xyz, xyz_mask, features, new_xyz, radius: float, nsample: int):
    """(B, M, nsample, 3 + C): each centre's in-ball sources, their offsets
    to the centre first, then ``features`` (B, N, C); zeros for an empty
    ball."""
    idx, empty = ball_query_masked(xyz, xyz_mask, new_xyz, radius, nsample)
    b, m, ns = idx.shape
    flat = idx.reshape(b, m * ns)
    grouped_xyz = gather_points(xyz, flat).reshape(b, m, ns, 3) - new_xyz[:, :, None, :]
    grouped_feat = gather_points(features, flat).reshape(b, m, ns, -1)
    out = torch.cat([grouped_xyz, grouped_feat], dim=-1)
    return torch.where(empty[:, :, None, None], 0.0, out)
