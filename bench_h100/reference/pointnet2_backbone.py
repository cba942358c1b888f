# Frozen copy of modest_tpu_torch/models/pointnet2_backbone.py, the benchmark's plain reference: it
# imports nothing of the port and changes only when the benchmark is redefined.
"""PointNet++ MSG backbone — port of ``modest_tpu/models/pointnet2_backbone.py``
(reference pcdet backbones_3d/pointnet2_backbone.py), exact-mode branches.

Channel-last: points (B, N, 3+C). Submodules carry pcdet's names
(``SA_modules.i.mlps.j``, ``FP_modules.k.mlp``), so a pcdet state dict maps
key for key.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from . import pointnet2 as p2
from .layers import SharedMLP


class SAModuleMSG(nn.Module):
    """Multi-scale-grouping set abstraction level."""

    def __init__(self, in_channels: int, npoint: int, radii: Sequence[float],
                 nsamples: Sequence[int], mlps: Sequence[Sequence[int]]):
        super().__init__()
        self.npoint = int(npoint)
        self.radii = [float(r) for r in radii]
        self.nsamples = [int(s) for s in nsamples]
        self.mlps = nn.ModuleList(SharedMLP(in_channels + 3, m) for m in mlps)
        self.out_channels = sum(m.out_channels for m in self.mlps)

    def forward(self, xyz, features):
        """xyz (B, N, 3); features (B, N, C) or None →
        (new_xyz (B, npoint, 3), new_features (B, npoint, sum(mlp[-1])))."""
        fps_idx = p2.furthest_point_sample(xyz, self.npoint)
        new_xyz = p2.gather_points(xyz, fps_idx)
        d2 = p2.pairwise_dist2(new_xyz, xyz)  # shared across the scales
        outs = []
        for radius, nsample, mlp in zip(self.radii, self.nsamples, self.mlps):
            grouped = p2.query_and_group(xyz, new_xyz, features, d2, radius, nsample)
            outs.append(mlp(grouped).amax(dim=2))
            del grouped
        return new_xyz, torch.cat(outs, dim=-1)


class SAModule(nn.Module):
    """Single-scale SA; npoint=None → GroupAll (reference PointnetSAModule).
    Its MLP has batch norm whatever the config's USE_BN says, as in JAX."""

    def __init__(self, in_channels: int, npoint, radius: float, nsample: int,
                 mlp: Sequence[int]):
        super().__init__()
        self.npoint = None if npoint is None else int(npoint)
        self.radius = float(radius)
        self.nsample = int(nsample)
        self.mlps = nn.ModuleList([SharedMLP(in_channels + 3, mlp)])
        self.out_channels = self.mlps[0].out_channels

    def forward(self, xyz, features):
        if self.npoint is None:
            grouped = p2.group_all(xyz, features)  # (B, 1, N, 3+C)
            new_xyz = torch.zeros(xyz.shape[0], 1, 3, dtype=xyz.dtype, device=xyz.device)
        else:
            fps_idx = p2.furthest_point_sample(xyz, self.npoint)
            new_xyz = p2.gather_points(xyz, fps_idx)
            d2 = p2.pairwise_dist2(new_xyz, xyz)
            grouped = p2.query_and_group(xyz, new_xyz, features, d2, self.radius, self.nsample)
        return new_xyz, self.mlps[0](grouped).amax(dim=2)


class FPModule(nn.Module):
    """Feature propagation (upsampling) level."""

    def __init__(self, in_channels: int, mlp: Sequence[int]):
        super().__init__()
        self.mlp = SharedMLP(in_channels, mlp)
        self.out_channels = self.mlp.out_channels

    def forward(self, unknown, known, unknown_feats, known_feats):
        interp = p2.interpolate_features(unknown, known, known_feats)
        if unknown_feats is not None:
            interp = torch.cat([interp, unknown_feats], dim=-1)
        return self.mlp(interp)


class PointNet2MSG(nn.Module):
    """4-level SA + 4-level FP encoder-decoder over raw points.

    ``FP_modules[k]`` upsamples level k+1 onto level k; the forward runs them
    deepest first (JAX's ``FPModule_i`` is ``FP_modules[n-1-i]``)."""

    def __init__(self, model_cfg, input_channels: int):
        super().__init__()
        sa = model_cfg.SA_CONFIG
        channel_in = input_channels - 3
        skip = [channel_in]
        self.SA_modules = nn.ModuleList()
        for k in range(len(sa.NPOINTS)):
            mod = SAModuleMSG(channel_in, sa.NPOINTS[k], sa.RADIUS[k], sa.NSAMPLE[k], sa.MLPS[k])
            self.SA_modules.append(mod)
            channel_in = mod.out_channels
            skip.append(channel_in)
        fp_mlps = model_cfg.FP_MLPS
        self.FP_modules = nn.ModuleList()
        for k in range(len(fp_mlps)):
            pre = fp_mlps[k + 1][-1] if k + 1 < len(fp_mlps) else channel_in
            self.FP_modules.append(FPModule(pre + skip[k], fp_mlps[k]))
        self.num_point_features = fp_mlps[0][-1]

    def forward(self, points):
        """points (B, N, 3+C) → per-point features (B, N, FP_MLPS[0][-1])."""
        xyz = points[..., :3].contiguous()
        features = points[..., 3:].contiguous() if points.shape[-1] > 3 else None
        l_xyz, l_feats = [xyz], [features]
        for sa in self.SA_modules:
            nx, nf = sa(l_xyz[-1], l_feats[-1])
            l_xyz.append(nx)
            l_feats.append(nf)
        for k in range(len(self.FP_modules) - 1, -1, -1):
            l_feats[k] = self.FP_modules[k](l_xyz[k], l_xyz[k + 1], l_feats[k], l_feats[k + 1])
            l_feats[k + 1] = None  # free the level once it has been propagated
        return l_feats[0]
