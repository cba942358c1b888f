"""Seeded detector weights, made on the device, and the calibration that
makes random weights score like a detector.

``seeded_weights`` draws every Linear, convolution and sparse-convolution
weight U(±1/sqrt(fan_in)) (the port's ``models/layers.py::init_parameters``
law) from one ``torch.Generator`` on the model's device in one call, zeroes
the biases, and draws every BatchNorm1d's running statistics (mean U(±0.3),
var U(0.5, 1.5): ``chip_smoke.py::randomise_bn``'s law) in a second call.
``calibrate_grid`` follows ``chip_smoke.py::calibrate_grid_model`` (batch-norm
statistics from one train-mode pass), then sets the heads so that the work
that reaches the post NMS does not change with the seed.
"""
from __future__ import annotations

import math

import torch
from torch import nn

# a calibrated head: anchors a scan above the score threshold, and the spread
# of the box residuals
CANDIDATES = 1024
BOX_RESIDUAL_STD = 0.1


def _weighted(model: nn.Module):
    return [m for m in model.modules()
            if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)) or hasattr(m, "fan_in")]


@torch.no_grad()
def seeded_weights(model: nn.Module, seed: int) -> None:
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    leaves = _weighted(model)
    draw = torch.rand(sum(m.weight.numel() for m in leaves), generator=gen, device=dev)
    at = 0
    for m in leaves:
        fan_in = getattr(m, "fan_in", None) or nn.init._calculate_fan_in_and_fan_out(m.weight)[0]
        n = m.weight.numel()
        m.weight.copy_(((draw[at:at + n] * 2 - 1) * fan_in ** -0.5).view_as(m.weight))
        at += n
        if getattr(m, "bias", None) is not None:
            m.bias.zero_()
    norms = [m for m in model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    for m in norms:
        m.reset_parameters()
    ones = [m for m in norms if isinstance(m, nn.BatchNorm1d)]
    stats = torch.rand(2 * sum(m.num_features for m in ones), generator=gen, device=dev)
    at = 0
    for m in ones:
        c = m.num_features
        m.running_mean.copy_((stats[at:at + c] - 0.5) * 0.6)
        m.running_var.copy_(stats[at + c:at + 2 * c] + 0.5)
        at += 2 * c


def calibrate_grid(model: nn.Module, train_forward, eval_forward, pool, gt_boxes,
                   score_thresh: float) -> None:
    """``train_forward(points, gt_boxes)`` and ``eval_forward(points)`` run the
    model's train and eval forwards (the reference's); ``pool`` holds every
    batch of the run (P, B, N, C), ``gt_boxes`` the first batch's boxes.
    Batch-norm statistics come from one train-mode pass over the first
    batch; then, from eval passes over the whole pool, each box head's
    (``*conv_box``) weights are scaled so that every output channel's
    residuals spread by ``BOX_RESIDUAL_STD`` around a zero bias (a trained
    head's residuals are small), and each class head's (``*conv_cls``) bias
    is moved so that ``CANDIDATES`` anchors a scan, over the pool's scans,
    score above ``score_thresh``. So the boxes that reach the post NMS,
    their number and their sizes, are alike for every seed."""
    bns = [m for m in model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    momenta = [m.momentum for m in bns]
    for m in bns:
        m.momentum = 1.0
    with torch.no_grad():
        train_forward(pool[0], gt_boxes)
    for m, momentum in zip(bns, momenta):
        m.momentum = momentum
    heads = {name: m for name, m in model.named_modules()
             if name.endswith("conv_cls") or name.endswith("conv_box")}
    outputs = {name: [] for name in heads}
    hooks = [m.register_forward_hook(lambda m, i, out, name=name: outputs[name].append(out))
             for name, m in heads.items()]
    for points in pool:
        eval_forward(points)
    for hook in hooks:
        hook.remove()
    threshold = math.log(score_thresh / (1 - score_thresh))
    with torch.no_grad():
        for name, head in heads.items():
            out = torch.cat(outputs[name])  # (P·B, channels, H, W)
            if name.endswith("conv_box"):
                spread = out.transpose(0, 1).flatten(1).std(dim=1).clamp_min(1e-12)
                head.weight.mul_((BOX_RESIDUAL_STD / spread).view(-1, *[1] * (head.weight.ndim - 1)))
                head.bias.zero_()
            else:
                kth = out.flatten().topk(CANDIDATES * out.shape[0]).values[-1]
                head.bias += threshold - kth
    model.eval()
