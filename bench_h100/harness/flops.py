"""Analytic FLOPs of a forward, counted on the reference as it runs.

Two FLOPs per multiply-add of every Linear (the shared MLPs and FC heads),
Conv1d, Conv2d and ConvTranspose2d at the shapes it is called with, and of
every sparse convolution over the rulebook pairs its call finds: an output
voxel that is active and an input voxel in its window that is active. NMS,
gathers, sorts and elementwise work are not counted.
"""
from __future__ import annotations

import contextlib
import math

import torch
from torch import nn


class FlopCounter:
    def __init__(self):
        self.flops = 0

    def _dense(self, module, inputs, output):
        if isinstance(module, nn.Linear):
            self.flops += 2 * output.numel() * module.in_features
        elif isinstance(module, nn.ConvTranspose2d):
            kernel = math.prod(module.kernel_size)
            self.flops += (2 * inputs[0].numel() * kernel * module.out_channels
                           // module.groups)
        elif isinstance(module, (nn.Conv1d, nn.Conv2d)):
            kernel = math.prod(module.kernel_size)
            self.flops += 2 * output.numel() * kernel * module.in_channels // module.groups

    @contextlib.contextmanager
    def counting(self, model: nn.Module, sparse_module=None):
        """Count every forward of ``model``'s dense layers, and of the sparse
        convolutions of ``sparse_module`` (the reference's ``sparse_conv``),
        while the context is open."""
        hooks = [m.register_forward_hook(self._dense) for m in model.modules()
                 if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d))]
        patched = []
        if sparse_module is not None:
            gather_rows, contract = sparse_module.gather_rows, sparse_module._contract
            hits = []

            def counted_gather(feats, rows):
                hits.append(rows < feats.shape[0] * feats.shape[1])
                return gather_rows(feats, rows)

            def counted_contract(gathered, weight, out_valid):
                hit = hits.pop()
                pairs = int((hit & out_valid[..., None]).sum())
                self.flops += 2 * pairs * weight.shape[-2] * weight.shape[-1]
                return contract(gathered, weight, out_valid)

            sparse_module.gather_rows, sparse_module._contract = counted_gather, counted_contract
            patched = [(sparse_module, "gather_rows", gather_rows),
                       (sparse_module, "_contract", contract)]
        try:
            yield self
        finally:
            for hook in hooks:
                hook.remove()
            for owner, name, value in patched:
                setattr(owner, name, value)


def count(model, forward, sparse_module=None) -> int:
    """FLOPs of one call of ``forward()`` on ``model``."""
    counter = FlopCounter()
    with counter.counting(model, sparse_module), torch.inference_mode():
        forward()
    return counter.flops
