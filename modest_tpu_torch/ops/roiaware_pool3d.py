"""RoI-aware voxel pooling — port of ``modest_tpu/ops/roiaware_pool3d.py``
(reference pcdet/ops/roiaware_pool3d).

Each RoI's canonical frame splits the box into gx × gy × gz cells (x along
its length dx, y its width dy, z its height dz; z is the box's geometric
centre, as in the JAX package). A point inside the box lands in one cell;
the cells pool their points' features by max or mean, and an empty cell is
0. Only the (scan, RoI, point) triples inside a box are gathered, so no
copy of the features per RoI is made; the pools are ``scatter_reduce``
into the cells. Like the JAX version this is plain tensor code (XLA there,
no Pallas kernel).
"""
from __future__ import annotations

import torch


def roiaware_cells(rois, points, out_size):
    """rois (B, R, 7); points (B, P, 3) → (b, r, p, cell) of every point
    inside a box: its scan, RoI, point and flat cell (ix·gy + iy)·gz + iz."""
    gx, gy, gz = out_size
    ctr, dims, ry = rois[..., None, 0:3], rois[..., None, 3:6], rois[..., None, 6]
    local = points[:, None, :, :] - ctr  # (B, R, P, 3)
    c, s = torch.cos(-ry), torch.sin(-ry)
    lx = local[..., 0] * c - local[..., 1] * s
    ly = local[..., 0] * s + local[..., 1] * c
    lz = local[..., 2]
    dx, dy, dz = dims[..., 0], dims[..., 1], dims[..., 2]
    in_box = (lx.abs() < dx / 2) & (ly.abs() < dy / 2) & (lz.abs() < dz / 2)
    b, r, p = torch.nonzero(in_box, as_tuple=True)

    def index(l, d, g):
        v = torch.floor((l[b, r, p] + d[b, r, 0] / 2) / d[b, r, 0] * g)
        return v.clamp(0, g - 1).to(torch.int64)

    cell = (index(lx, dx, gx) * gy + index(ly, dy, gy)) * gz + index(lz, dz, gz)
    return b, r, p, cell


def roiaware_pool3d(rois, points, point_features, out_size=(6, 6, 6), pool_method="max",
                    cells=None):
    """rois (B, R, 7) [x y z dx dy dz heading]; points (B, P, 3);
    point_features (B, P, C) → (B, R, gx, gy, gz, C). ``cells``, from
    ``roiaware_cells`` for the same rois, points and ``out_size``, saves
    computing them again for a second pool."""
    if isinstance(out_size, int):
        out_size = (out_size,) * 3
    gx, gy, gz = out_size
    nb, nr = rois.shape[:2]
    ch = point_features.shape[-1]
    n_cells = gx * gy * gz
    b, r, p, cell = cells if cells is not None else roiaware_cells(rois, points, out_size)
    flat = (b * nr + r) * n_cells + cell
    src = point_features[b, p]
    out = point_features.new_zeros(nb * nr * n_cells, ch)
    if pool_method == "max":
        out = out.scatter_reduce(0, flat[:, None].expand(-1, ch), src, "amax",
                                 include_self=False)
    else:
        counts = torch.zeros(nb * nr * n_cells, dtype=point_features.dtype,
                             device=point_features.device)
        counts = counts.index_add(0, flat, torch.ones_like(flat, dtype=counts.dtype))
        out = out.index_add(0, flat, src) / counts.clamp_min(1.0)[:, None]
    return out.reshape(nb, nr, gx, gy, gz, ch)
