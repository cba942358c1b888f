"""Shared NN building blocks, channel-last — port of
``modest_tpu/models/layers.py`` (f32 throughout, as in the JAX exact mode).

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


class SharedMLP(nn.Sequential):
    """Stack of [Linear (bias only without BN) → BatchNorm → ReLU] on the last
    axis. Batch norm sees the rows flattened to (-1, C); the slice is eval
    only, so it normalises with its running statistics."""

    def __init__(self, in_channels: int, channels: Sequence[int], use_bn: bool = True):
        layers = []
        c_in = in_channels
        for c in channels:
            layers.append(nn.Linear(c_in, c, bias=not use_bn))
            if use_bn:
                layers.append(nn.BatchNorm1d(c, eps=1e-5, momentum=0.1))
            layers.append(nn.ReLU())
            c_in = c
        super().__init__(*layers)
        self.out_channels = c_in

    def forward(self, x):
        for layer in self:
            if isinstance(layer, nn.BatchNorm1d):
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
    """Seeded init of every Linear and BatchNorm1d below ``module``.

    Linear weights draw U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (PyTorch's
    default bound) and biases start at 0; batch norms start at the identity
    (scale 1, shift 0, running mean 0, running var 1). Drawn on the CPU, so
    one seed gives the same weights whatever device the module lives on."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            bound = m.in_features ** -0.5
            w = torch.empty(m.weight.shape).uniform_(-bound, bound, generator=generator)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm1d):
            m.reset_parameters()
