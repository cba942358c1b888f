"""Shared NN building blocks — port of ``modest_tpu/models/layers.py`` (f32
throughout, as in the JAX exact mode), and the batch norms of the grid
detectors.

The stacks are ``nn.Sequential``s laid out like pcdet's 1x1-conv stacks
(linear, [batch norm], ReLU, ...), so their state-dict keys follow pcdet's
numbering and ``modest_tpu.train.torch_convert`` reads them unchanged. A 1x1
convolution over (B, C, npoint, nsample) is a ``nn.Linear`` over the last
axis of the channel-last layout.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class BatchNorm(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` that trains as flax's ``nn.BatchNorm(momentum=0.9,
    epsilon=1e-5)`` does (``modest_tpu/models/layers.py``).

    In train mode it normalises (N, C) rows by their mean and their
    *biased* variance E[x²] − E[x]² (clipped at 0, flax's fast variance),
    as (x − mean) · (rsqrt(var + eps) · weight) + bias, and moves the
    running statistics by r ← 0.9 r + 0.1 · batch with that same biased
    variance; ``nn.BatchNorm1d`` would move them with the unbiased one. In
    eval mode it is ``nn.BatchNorm1d``. The keys and the momentum (0.1 in
    torch's convention) are ``nn.BatchNorm1d``'s."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        return _flax_train_norm(self, x, (0,), (1, -1))


def _update_running(bn, mean, var):
    with torch.no_grad():
        keep = 1.0 - bn.momentum
        bn.running_mean.copy_(keep * bn.running_mean + (1.0 - keep) * mean)
        bn.running_var.copy_(keep * bn.running_var + (1.0 - keep) * var)
        bn.num_batches_tracked.add_(1)


def _flax_train_norm(bn, x, dims, shape):
    """flax's train-mode batch norm over ``dims`` of ``x``: the fast biased
    variance, the running statistics moved by it, and (x − mean) ·
    (rsqrt(var + eps) · weight) + bias; per-channel vectors are viewed as
    ``shape``."""
    mean = x.mean(dim=dims)
    var = torch.clamp_min((x * x).mean(dim=dims) - mean * mean, 0.0)
    _update_running(bn, mean, var)
    return ((x - mean.view(shape)) * (torch.rsqrt(var + bn.eps) * bn.weight).view(shape)
            + bn.bias.view(shape))


class _Im2colConv2d(torch.autograd.Function):
    """A bias-free conv2d forward and backward with cuDNN switched off,
    which PyTorch runs as im2col and a GEMM."""

    @staticmethod
    def forward(ctx, x, weight, stride, padding):
        with torch.backends.cudnn.flags(enabled=False):
            y = nn.functional.conv2d(x, weight, None, stride, padding)
        ctx.save_for_backward(x, weight)
        ctx.conf = (stride, padding)
        return y

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        stride, padding = ctx.conf
        with torch.backends.cudnn.flags(enabled=False):
            gx, gw, _ = torch.ops.aten.convolution_backward(
                grad, x, weight, None, stride, padding, (1, 1), False, (0, 0), 1,
                (ctx.needs_input_grad[0], ctx.needs_input_grad[1], False))
        return gx, gw, None, None


# the stride-1 BEV convs to 128 channels that run cuDNN off: every one from
# 256 channels (SECOND's level-1 opener on the Lyft, KITTI and CBGS maps), and
# from 128 channels on a map of at least IM2COL_MIN_SITES cells (level 1 of
# SECOND on Lyft, 200 × 226, and KITTI, 200 × 176; CBGS's 128 × 128 and
# PointPillars' 128-channel levels stay on cuDNN)
IM2COL_MIN_SITES = 35_000


def conv_uses_cudnn(in_channels: int, out_channels: int, hw, stride) -> bool:
    """Whether ``Conv2d`` runs an input map of ``hw`` cells on cuDNN (else
    cuDNN off: im2col and a GEMM). A rule of the shape, so a run's route
    and rounding do not depend on timing."""
    if tuple(stride) != (1, 1) or out_channels != 128 or in_channels < 128:
        return True
    return in_channels < 256 and hw[0] * hw[1] < IM2COL_MIN_SITES


class Conv2d(nn.Conv2d):
    """A bias-free ``nn.Conv2d`` (groups 1, dilation 1) that runs on the card
    on one of two routes, cuDNN or cuDNN off (im2col and a GEMM), as
    ``conv_uses_cudnn`` picks from the shape. On the H100 in float32, cuDNN's
    heuristics take FFT tiling for SECOND's stride-1 convs on its 200 × 226
    BEV map, and neither its benchmark mode nor channels_last finds better:
    365 ms against 3.7 for the 256 → 128 conv, 12.6 against 2.0 for 128 →
    128; the 256 → 128 conv takes 250–300 ms on cuDNN at every map size
    measured (KITTI's 200 × 176, CBGS's 128 × 128), 1.3–3.7 off it; cuDNN is
    the faster route for the configs' other BEV convs
    (``tools/grid_probe.py convs`` times each shape on both routes, PERF.md
    §6). Both routes compute the same convolution; they round
    differently. The CPU always takes ``nn.Conv2d``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=1,
                 padding=0):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, bias=False)

    def forward(self, x):
        if not x.is_cuda or conv_uses_cudnn(self.in_channels, self.out_channels, x.shape[-2:],
                                            self.stride):
            return super().forward(x)
        return _Im2colConv2d.apply(x, self.weight, self.stride, self.padding)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` that trains as flax's ``nn.BatchNorm(momentum=0.99,
    epsilon=1e-3)`` does over a channel-last map (``BEVBackbone`` of
    ``modest_tpu/models/grid_detectors.py``): statistics over (B, H, W), the
    fast biased variance, r ← 0.99 r + 0.01 · batch. Eval mode is
    ``nn.BatchNorm2d``'s; the keys are its keys."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-3, momentum=0.01)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        return _flax_train_norm(self, x, (0, 2, 3), (1, -1, 1, 1))


class BatchNorm3d(nn.BatchNorm3d):
    """``nn.BatchNorm3d`` that trains as flax's ``nn.BatchNorm(momentum=0.9,
    epsilon=1e-5)`` does over a channel-last volume (Part-A2's RoI conv
    tower): statistics over (N, D, H, W), the fast biased variance, r ← 0.9 r
    + 0.1 · batch. Eval mode is ``nn.BatchNorm3d``'s; the keys are its keys."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        return _flax_train_norm(self, x, (0, 2, 3, 4), (1, -1, 1, 1, 1))


class MaskedBatchNorm(nn.BatchNorm1d):
    """Batch norm over the masked rows of a padded batch — port of
    ``MaskedBatchNorm`` in ``modest_tpu/models/layers.py``.

    ``forward(x (..., C), mask (...))``. In train mode the statistics cover
    every masked row of the whole batch (the population the reference's
    BN1d sees), with the two-pass biased variance Σw(x − mean)² / Σw, and the
    running statistics move by r ← 0.99 r + 0.01 · batch. Unmasked rows come
    out 0. The keys are ``nn.BatchNorm1d``'s (pcdet's ``norm_fn``, eps 1e-3,
    momentum 0.01)."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-3, momentum=0.01)

    def forward(self, x, mask):
        c = x.shape[-1]
        xf = x.reshape(-1, c)
        mf = mask.reshape(-1)
        if self.training:
            w = mf.to(xf.dtype)[:, None]
            cnt = torch.clamp_min(w.sum(), 1.0)
            mean = (xf * w).sum(0) / cnt
            var = (torch.square(xf - mean) * w).sum(0) / cnt
            _update_running(self, mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        y = torch.where(mf[:, None], y, 0.0)
        return y.reshape(x.shape)


class SharedMLP(nn.Sequential):
    """Stack of [Linear (bias only without BN) → BatchNorm → ReLU] on the last
    axis. Batch norm sees the rows flattened to (-1, C)."""

    def __init__(self, in_channels: int, channels: Sequence[int], use_bn: bool = True):
        layers = []
        c_in = in_channels
        for c in channels:
            layers.append(nn.Linear(c_in, c, bias=not use_bn))
            if use_bn:
                layers.append(BatchNorm(c, eps=1e-5, momentum=0.1))
            layers.append(nn.ReLU())
            c_in = c
        super().__init__(*layers)
        self.out_channels = c_in

    def forward(self, x):
        for layer in self:
            if isinstance(layer, BatchNorm):
                x = layer(x.reshape(-1, x.shape[-1])).reshape(x.shape)
            else:
                x = layer(x)
        return x


class FCHead(SharedMLP):
    """[Linear(no bias) + BN + ReLU] * k + Linear(out, bias) — reference
    make_fc_layers. The hidden stack always has batch norm, as in JAX."""

    def __init__(self, in_channels: int, hidden: Sequence[int], out: int):
        super().__init__(in_channels, hidden, use_bn=True)
        self.append(nn.Linear(self.out_channels, out, bias=True))
        self.out_channels = out


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init of every Linear, convolution and batch norm below
    ``module``.

    Weights draw U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (PyTorch's default
    bound; a module's ``fan_in`` attribute, where it has one, names its fan-in)
    and biases start at 0; batch norms start at the identity (scale 1, shift
    0, running mean 0, running var 1). Drawn on the CPU, so one seed gives
    the same weights whatever device the module lives on."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)) or hasattr(m, "fan_in"):
            fan_in = getattr(m, "fan_in", None) or nn.init._calculate_fan_in_and_fan_out(
                m.weight)[0]
            bound = fan_in ** -0.5
            w = torch.empty(m.weight.shape).uniform_(-bound, bound, generator=generator)
            m.weight.copy_(w)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()
