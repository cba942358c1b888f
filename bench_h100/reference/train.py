"""The reference's training step: a frozen copy of the port's single-process
``train/state.py::train_step`` and ``step_roi_draws``, over the reference's
detectors, losses and optimizer."""
from __future__ import annotations

import torch

from .config import Config
from .grid_detectors import GridDetector, grid_detector_loss
from .optim import build_optimizer
from .pointrcnn import PointRCNN, pointrcnn_loss
from .roi_head import sampler_draws


def step_roi_draws(model_cfg, batch_size: int, step: int, seed: int, device):
    """The RoI sampler's draws for step ``step`` of a run seeded ``seed``."""
    rh = model_cfg.ROI_HEAD
    gen = torch.Generator().manual_seed(seed * 1_000_003 + step)
    return sampler_draws(batch_size, int(rh.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE),
                         int(rh.TARGET_CONFIG.ROI_PER_IMAGE), device, gen)


def optimizer(model, cfg: dict, total_steps: int):
    return build_optimizer(model.parameters(), Config(cfg["OPTIMIZATION"]), total_steps)


def train_step(model, opt, points, gt_boxes, *, seed: int, max_voxels: int | None = None):
    """One optimizer step; returns (total loss, the loss terms) as floats."""
    model.train()
    for p in model.parameters():
        p.grad = None
    cfg = model.model_cfg
    if isinstance(model, PointRCNN):
        draws = step_roi_draws(cfg, points.shape[0], opt.count, seed, points.device)
        out = model(points, gt_boxes, roi_draws=draws)
        loss, metrics = pointrcnn_loss(out, gt_boxes, cfg, model.num_class)
    elif isinstance(model, GridDetector):
        out = model(points, gt_boxes, max_voxels=max_voxels)
        loss, metrics = grid_detector_loss(out, cfg, model.num_class)
    else:
        raise NotImplementedError(type(model).__name__)
    loss.backward()
    opt.step()
    return {k: float(v.detach()) for k, v in metrics.items()}
