"""3D sparse convolution as gather-scatter over active voxels — port of
``modest_tpu/models/sparse_conv.py`` (reference backbones_3d/spconv_backbone.py,
VoxelBackBone8x), with no sparse-convolution package.

The active set of each scan is a sorted, padded list of flat keys. A
submanifold conv finds each voxel's 27 neighbours by ``torch.searchsorted``
over the sorted keys, gathers their features and contracts (V, 27·Cin) ×
(27·Cin, Cout) in one ``torch.matmul``. A strided conv first lists the ≤ 8
candidate output sites of each input (kernel 3, stride ≤ 2), keeps the
unique ones by a sort, then gathers its input windows the same way. Shapes
are static; padded voxels ride along masked. The neighbour lookup of a
scale (its "rulebook") is computed once and shared by the scale's convs.

Weights are laid out as spconv 1.x stores them, (kz, ky, kx, Cin, Cout), so
that flattening gives the window-major, channel-minor (kvol·Cin, Cout)
matrix of the JAX package, and module names follow pcdet's
``VoxelBackBone8x`` (``conv_input.0.weight``, ``conv2.0.1.running_mean``, ...).
"""
from __future__ import annotations

import torch
from torch import nn

from .layers import MaskedBatchNorm
from .voxelize import _unique_sorted, key_to_zyx

OFFSETS3 = tuple((dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1))


def flat_key(coords, shape_zyx):
    """(..., 3) zyx coords → (flat keys, in-bounds); out of bounds → nz·ny·nx."""
    nz, ny, nx = shape_zyx
    dims = torch.tensor([nz, ny, nx], device=coords.device)
    inb = ((coords >= 0) & (coords < dims)).all(-1)
    key = coords[..., 0] * ny * nx + coords[..., 1] * nx + coords[..., 2]
    return torch.where(inb, key, nz * ny * nx), inb


def neighbor_index(keys, valid, coords, shape_zyx, offsets, stride=1, padding=0):
    """Rows of the input table that feed each output voxel's kernel window.

    keys (B, V) sorted input keys, valid (B, V); coords (B, Vo, 3) output
    coords (zyx). Window input coords are stride·coord − padding + offset.
    Returns (B, Vo, K) indices into the batch's inputs flattened to (B·V)
    rows, with B·V (one zero row past the end) where a window cell holds no
    active input."""
    b, v = keys.shape
    dev = coords.device
    off = torch.tensor(offsets, dtype=coords.dtype, device=dev)
    base = coords * torch.as_tensor(stride, device=dev) - torch.as_tensor(padding, device=dev)
    nbr_key, inb = flat_key(base[:, :, None, :] + off, shape_zyx)  # (B, Vo, K)
    idx = torch.searchsorted(keys, nbr_key.reshape(b, -1)).reshape(nbr_key.shape)
    idx_c = idx.clamp_max(v - 1)
    flat_keys = keys.gather(1, idx_c.reshape(b, -1)).reshape(idx_c.shape)
    flat_valid = valid.gather(1, idx_c.reshape(b, -1)).reshape(idx_c.shape)
    hit = inb & (flat_keys == nbr_key) & flat_valid
    rows = idx_c + v * torch.arange(b, device=dev)[:, None, None]
    return torch.where(hit, rows, b * v)


def gather_rows(feats, rows):
    """feats (B, V, C), rows from ``neighbor_index`` → (B, Vo, K, C), 0 where
    the window cell is empty.

    An embedding lookup with the zero row as ``padding_idx``: most window
    cells are empty, and an indexing gather's backward adds their gradient
    into that one row serially (6.5 s a SECOND step on the card, against
    0.2 s this way; PERF.md, PR 9)."""
    b, v, c = feats.shape
    table = torch.cat([feats.reshape(b * v, c), feats.new_zeros(1, c)])
    return nn.functional.embedding(rows, table, padding_idx=b * v)


def gather_neighbors(feats, keys, valid, coords, shape_zyx, offsets=OFFSETS3, stride=1):
    """For each output voxel, its kernel window's input features (B, Vo, K,
    C), 0 where missing (the JAX package's ``gather_neighbors``, batched)."""
    return gather_rows(feats, neighbor_index(keys, valid, coords, shape_zyx, offsets, stride))


def _contract(gathered, weight, out_valid):
    b, v, k, c = gathered.shape
    out = torch.matmul(gathered.reshape(b * v, k * c), weight.reshape(k * c, -1))
    return torch.where(out_valid[..., None], out.reshape(b, v, -1), 0.0)


class SubMConv3d(nn.Module):
    """Submanifold conv: outputs live exactly on the input active set.
    ``forward(feats (B, V, Cin), rows, valid)`` with ``rows`` the scale's
    rulebook (``neighbor_index`` at stride 1, the 27 offsets of OFFSETS3)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(kernel, kernel, kernel, in_channels,
                                               out_channels))
        self.fan_in = kernel ** 3 * in_channels

    def forward(self, feats, rows, valid):
        return _contract(gather_rows(feats, rows), self.weight, valid)


def downsample_active_set(coords, valid, out_shape_zyx, stride, padding, max_out: int):
    """Active output sites of a strided sparse conv, batched.

    For kernel 3, stride s, padding p, output o covers inputs i ∈ [s·o − p,
    s·o − p + 2]: an input has at most 2 candidate outputs per dim for
    s ∈ {1, 2}. The candidates of every dim use that kernel-3 window (also
    for ``conv_out``'s (3, 1, 1) kernel, as in the JAX package). Each scan
    keeps its ``max_out`` unique sites of lowest key. coords (B, V, 3) zyx;
    returns (coords (B, max_out, 3), keys (B, max_out), valid (B, max_out))."""
    nz, ny, nx = out_shape_zyx
    big = nz * ny * nx
    dev = coords.device
    stride = torch.tensor(stride, device=dev)
    padding = torch.tensor(padding, device=dev)
    dims = torch.tensor([nz, ny, nx], device=dev)
    hi = torch.div(coords + padding, stride, rounding_mode="floor")
    cands = []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                c = hi - torch.tensor([dz, dy, dx], device=dev)
                lo_in = c * stride - padding
                ok = ((coords >= lo_in) & (coords <= lo_in + 2)).all(-1)
                ok &= ((c >= 0) & (c < dims)).all(-1)
                cands.append(torch.where(ok & valid, c[..., 0] * ny * nx + c[..., 1] * nx
                                         + c[..., 2], big))
    out_keys = _unique_sorted(torch.cat(cands, dim=1), big, max_out)
    return key_to_zyx(out_keys, ny, nx), out_keys, out_keys < big


class SparseConv3d(nn.Module):
    """Strided sparse conv: its output active set is the downsampled input
    set, capped at the input's length (``max_out``)."""

    def __init__(self, in_channels: int, out_channels: int, stride, padding,
                 kernel=(3, 3, 3)):
        super().__init__()
        self.stride, self.padding, self.kernel = tuple(stride), tuple(padding), tuple(kernel)
        self.weight = nn.Parameter(torch.empty(*kernel, in_channels, out_channels))
        self.fan_in = kernel[0] * kernel[1] * kernel[2] * in_channels
        kz, ky, kx = kernel
        self.offsets = tuple((z, y, x) for z in range(kz) for y in range(ky) for x in range(kx))

    def forward(self, feats, coords, keys, valid, shape_zyx, out_shape_zyx, max_out=None):
        max_out = max_out or feats.shape[1]
        out_coords, out_keys, out_valid = downsample_active_set(
            coords, valid, out_shape_zyx, self.stride, self.padding, max_out)
        rows = neighbor_index(keys, valid, out_coords, shape_zyx, self.offsets,
                              self.stride, self.padding)
        out = _contract(gather_rows(feats, rows), self.weight, out_valid)
        return out, out_coords, out_keys, out_valid


class SparseBlock(nn.ModuleList):
    """[conv → MaskedBatchNorm → ReLU], pcdet's ``post_act_block``: keys
    ``0.weight`` (the conv) and ``1.*`` (the norm)."""

    def __init__(self, conv: nn.Module, out_channels: int):
        super().__init__([conv, MaskedBatchNorm(out_channels)])

    def forward(self, x, valid, *conv_args):
        return torch.relu(self[1](self[0](x, *conv_args), valid))


def down_shape(shape, stride, padding, kernel=(3, 3, 3)):
    return tuple((shape[i] + 2 * padding[i] - kernel[i]) // stride[i] + 1 for i in range(3))


def height_compress(x, keys, valid, shape_zyx):
    """Scatter each scan's active voxels into a dense BEV map: (B, V, C) →
    (B, nz·C, ny, nx) with channel z·C + c (the JAX package's order)."""
    nz, ny, nx = shape_zyx
    b, v, c = x.shape
    cells = nz * ny * nx
    k = torch.where(valid, keys, cells) + (cells + 1) * torch.arange(b, device=x.device)[:, None]
    dense = x.new_zeros(b * (cells + 1), c)
    dense = dense.index_copy(0, k.reshape(-1),
                             torch.where(valid[..., None], x, 0.0).reshape(-1, c))
    dense = dense.reshape(b, cells + 1, c)[:, :cells].reshape(b, nz, ny, nx, c)
    return dense.permute(0, 1, 4, 2, 3).reshape(b, nz * c, ny, nx)


# each scale's stride against the input voxel grid
BACKBONE_STRIDES = {"x_conv1": 1, "x_conv2": 2, "x_conv3": 4, "x_conv4": 8}


class VoxelBackBone8x(nn.Module):
    """spconv VoxelBackBone8x (reference spconv_backbone.py:68-180) on the
    gather-scatter convs. Input: each scan's active voxels of the (nz + 1,
    ny, nx) grid with their mean features; output: the dense BEV map
    (B, 2·128, ny/8, nx/8) after ``conv_out`` and height compression. With
    ``return_multiscale`` it returns (BEV map, scales): ``scales`` maps
    x_conv1..x_conv4 to that stage's (feats, coords zyx, valid, keys), the
    sources of PV-RCNN's voxel set abstraction (strides
    ``BACKBONE_STRIDES``)."""

    def __init__(self, in_channels: int = 4, return_multiscale: bool = False):
        super().__init__()
        self.return_multiscale = return_multiscale

        def subm(cin, cout):
            return SparseBlock(SubMConv3d(cin, cout), cout)

        def down(cin, cout, padding):
            return SparseBlock(SparseConv3d(cin, cout, (2, 2, 2), padding), cout)

        self.conv_input = subm(in_channels, 16)
        self.conv1 = nn.ModuleList([subm(16, 16)])
        self.conv2 = nn.ModuleList([down(16, 32, (1, 1, 1)), subm(32, 32), subm(32, 32)])
        self.conv3 = nn.ModuleList([down(32, 64, (1, 1, 1)), subm(64, 64), subm(64, 64)])
        self.conv4 = nn.ModuleList([down(64, 64, (0, 1, 1)), subm(64, 64), subm(64, 64)])
        self.conv_out = SparseBlock(SparseConv3d(64, 128, (2, 1, 1), (0, 0, 0), (3, 1, 1)), 128)
        self.num_bev_features = 2 * 128
        # with ``record_active`` set, a forward leaves each stage's active-site
        # count per scan in ``active_counts`` (no host read)
        self.record_active = False
        self.active_counts = {}

    def forward(self, feats, coords, keys, valid, shape_zyx):
        record = self.record_active
        counts = {"conv1": valid.sum(1)} if record else {}
        rows = neighbor_index(keys, valid, coords, shape_zyx, OFFSETS3)
        x = self.conv_input(feats, valid, rows, valid)
        x = self.conv1[0](x, valid, rows, valid)
        scales = {"x_conv1": (x, coords, valid, keys)}
        s = shape_zyx
        for name, stage in (("conv2", self.conv2), ("conv3", self.conv3), ("conv4", self.conv4)):
            conv = stage[0][0]
            s_out = down_shape(s, conv.stride, conv.padding)
            y, coords, keys, out_valid = conv(x, coords, keys, valid, s, s_out)
            x = torch.relu(stage[0][1](y, out_valid))
            valid, s = out_valid, s_out
            if record:
                counts[name] = valid.sum(1)
            rows = neighbor_index(keys, valid, coords, s, OFFSETS3)
            for block in stage[1:]:
                x = block(x, valid, rows, valid)
            scales[f"x_{name}"] = (x, coords, valid, keys)
        conv = self.conv_out[0]
        s_out = down_shape(s, conv.stride, conv.padding, conv.kernel)
        if record:
            counts["conv_out_kernel_sites"] = kernel_sites_z3(coords, valid, s_out)
        y, _, keys, valid = conv(x, coords, keys, valid, s, s_out)
        x = torch.relu(self.conv_out[1](y, valid))
        if record:
            counts["conv_out"] = valid.sum(1)
            self.active_counts = counts
        bev = height_compress(x, keys, valid, s_out)
        return (bev, scales) if self.return_multiscale else bev


def kernel_sites_z3(coords, valid, out_shape_zyx):
    """Per scan, the output sites a (3, 1, 1) kernel at stride (2, 1, 1),
    padding 0 reaches from the active inputs (spconv's rule for
    ``conv_out``): output (o, y, x) for each input (z, y, x) with 2o ≤ z ≤
    2o + 2. ``downsample_active_set`` also lists (y − 1) and (x − 1), as the
    JAX package does; the difference counts those extra sites."""
    nz, ny, nx = out_shape_zyx
    big = nz * ny * nx
    z = coords[..., 0]
    cands = []
    for dz in (0, 1):
        o = torch.div(z, 2, rounding_mode="floor") - dz
        ok = valid & (2 * o <= z) & (z <= 2 * o + 2) & (o >= 0) & (o < nz)
        cands.append(torch.where(ok, o * ny * nx + coords[..., 1] * nx + coords[..., 2], big))
    keys = torch.cat(cands, dim=1)
    return (_unique_sorted(keys, big, keys.shape[1]) < big).sum(1)


def backbone_scale_shapes(grid_size):
    """(nz, ny, nx) of each VoxelBackBone8x scale for a dataset grid_size
    (nx, ny, nz), as the forward's downsampling chain makes them; heads that
    address a scale's voxel keys (``voxel_query``) need them."""
    s1 = (grid_size[2] + 1, grid_size[1], grid_size[0])  # z padded like spconv
    s2 = down_shape(s1, (2, 2, 2), (1, 1, 1))
    s3 = down_shape(s2, (2, 2, 2), (1, 1, 1))
    s4 = down_shape(s3, (2, 2, 2), (0, 1, 1))
    return {"x_conv1": s1, "x_conv2": s2, "x_conv3": s3, "x_conv4": s4}


class SparseInverseConv3d(nn.Module):
    """Inverse (transposed) sparse conv from a coarse scale onto the known
    fine active set (reference spconv.SparseInverseConv3d in spconv_unet.py).

    A fine voxel f takes from every coarse voxel c whose kernel-3 window at
    ``stride`` and ``padding`` covers it, through the tap f − (s·c − p) ∈
    [0, 2]³: at most 2 candidates per dim, 8 in all, each at its own tap. So
    each candidate's coarse row is written into its tap's slot of a (Vf, 27)
    rulebook, and one embedding gather and one (Vf, 27·Cin) × (27·Cin, Cout)
    product make the output (the JAX package indexes a (Vf, Cin, Cout)
    weight per candidate instead)."""

    def __init__(self, in_channels: int, out_channels: int, stride=(2, 2, 2),
                 padding=(1, 1, 1)):
        super().__init__()
        self.stride, self.padding = tuple(stride), tuple(padding)
        self.weight = nn.Parameter(torch.empty(3, 3, 3, in_channels, out_channels))
        self.fan_in = 27 * in_channels

    def rulebook(self, coarse_keys, coarse_valid, coarse_shape_zyx, fine_coords):
        """(B, Vf, 27) rows of the coarse table flattened to (B·Vc) rows (B·Vc:
        the zero row) feeding each fine voxel's taps."""
        b, vc = coarse_keys.shape
        dev = fine_coords.device
        stride = torch.tensor(self.stride, device=dev)
        padding = torch.tensor(self.padding, device=dev)
        zero_row = b * vc
        hi = torch.div(fine_coords + padding, stride, rounding_mode="floor")
        rows = torch.full((*fine_coords.shape[:2], 27), zero_row, dtype=torch.int64,
                          device=dev)
        base = vc * torch.arange(b, device=dev)[:, None]
        for dz in (0, 1):
            for dy in (0, 1):
                for dx in (0, 1):
                    c = hi - torch.tensor([dz, dy, dx], device=dev)
                    tap = fine_coords - (c * stride - padding)
                    ok = ((tap >= 0) & (tap <= 2)).all(-1)
                    key, inb = flat_key(c, coarse_shape_zyx)
                    idx = torch.searchsorted(coarse_keys, key).clamp_max(vc - 1)
                    hit = (ok & inb & (coarse_keys.gather(1, idx) == key)
                           & coarse_valid.gather(1, idx))
                    tap_id = ((tap[..., 0] * 3 + tap[..., 1]) * 3 + tap[..., 2]).clamp(0, 26)
                    # only hits write, and a voxel's hits sit at distinct taps
                    rows = rows.scatter_reduce(2, tap_id[..., None],
                                               torch.where(hit, idx + base, zero_row)[..., None],
                                               "amin")
        return rows

    def forward(self, coarse_feats, coarse_keys, coarse_valid, coarse_shape_zyx, fine_coords,
                fine_valid):
        rows = self.rulebook(coarse_keys, coarse_valid, coarse_shape_zyx, fine_coords)
        return _contract(gather_rows(coarse_feats, rows), self.weight, fine_valid)


class SparseUNet(VoxelBackBone8x):
    """UNetV2 sparse encoder-decoder (reference backbones_3d/spconv_unet.py),
    as the JAX package's ``SparseUNet``: the VoxelBackBone8x encoder with its
    ``conv_out`` BEV map for the RPN, then back up by inverse convs, each
    merged with its scale's encoder features by a SubM conv: ``up4`` (x_conv4
    → x_conv3, 64), ``up3`` (→ x_conv2, 32), ``up2`` (→ x_conv1, 16).
    Returns (BEV map, (B, V, 16) features on the input voxels). Each ``up``
    holds ``inv`` and ``merge``, each a [conv → MaskedBatchNorm → ReLU]."""

    UP = (("up4", "x_conv4", "x_conv3", (0, 1, 1), 64, 64),
          ("up3", "x_conv3", "x_conv2", (1, 1, 1), 64, 32),
          ("up2", "x_conv2", "x_conv1", (1, 1, 1), 32, 16))

    def __init__(self, in_channels: int = 4):
        super().__init__(in_channels, return_multiscale=True)
        for name, _, _, padding, cin, cout in self.UP:
            self.add_module(name, nn.ModuleDict({
                "inv": SparseBlock(SparseInverseConv3d(cin, cout, (2, 2, 2), padding), cout),
                "merge": SparseBlock(SubMConv3d(2 * cout, cout), cout)}))

    def forward(self, feats, coords, keys, valid, shape_zyx):
        bev, scales = super().forward(feats, coords, keys, valid, shape_zyx)
        gs = (shape_zyx[2], shape_zyx[1], shape_zyx[0] - 1)
        shapes = backbone_scale_shapes(gs)
        u = scales["x_conv4"][0]
        for name, coarse, fine, _, _, _ in self.UP:
            up = getattr(self, name)
            _, _, cvalid, ckeys = scales[coarse]
            lateral, fcoords, fvalid, fkeys = scales[fine]
            x = up["inv"](u, fvalid, ckeys, cvalid, shapes[coarse], fcoords, fvalid)
            rows = neighbor_index(fkeys, fvalid, fcoords, shapes[fine], OFFSETS3)
            u = up["merge"](torch.cat([x, lateral], dim=-1), fvalid, rows, fvalid)
        return bev, u
