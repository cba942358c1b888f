"""Train state and one optimizer step — port of ``modest_tpu/train/state.py``.

A step is: forward in train mode, loss, backward, gradient clipping and the
update (``train/optim.py``). The RoI sampler of the detectors that sample RoIs
(``models/api.py::SAMPLES_ROIS``: PointRCNN, PVRCNN, VoxelRCNN, PartA2) draws
at step ``s`` from a ``torch.Generator`` seeded from (seed, s), as JAX folds
the step into its "sampler" key, so a resumed run draws as the
uninterrupted one would; so does CaDDN's DeepLab ASPP dropout, on the
device; the others (the grid detectors, SECOND-IoU) draw nothing.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models import api as model_api
from ..models.pointrcnn import STAGES
from ..models.roi_head import sampler_draws
from .optim import Optimizer, build_optimizer

# the forward's stages (in train mode "roi_pool" includes the RoI sampling), then the rest
STEP_STAGES = (*STAGES, "loss", "backward", "optimizer")


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Optimizer
    # what the train CLI ran: the epoch it started from and the loop's records
    start_epoch: int = 0
    history: list = dataclasses.field(default_factory=list)

    @property
    def step(self) -> int:
        return self.optimizer.count


def create_train_state(model, opt_cfg, total_steps: int, iters_per_epoch: int | None = None):
    return TrainState(model, build_optimizer(model.parameters(), opt_cfg, total_steps,
                                             iters_per_epoch))


def step_roi_draws(model_cfg, batch_size: int, step: int, seed: int, device):
    """The RoI sampler's draws for step ``step`` of a run seeded ``seed``."""
    rh = model_cfg.ROI_HEAD
    gen = torch.Generator().manual_seed(seed * 1_000_003 + step)
    return sampler_draws(batch_size, int(rh.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE),
                         int(rh.TARGET_CONFIG.ROI_PER_IMAGE), device, gen)


def step_dropout_generator(step: int, seed: int, device):
    """The generator CaDDN's DeepLab ASPP draws its dropout mask from at step
    ``step`` of a run seeded ``seed``, on ``device``."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + step)


def train_step(state: TrainState, model_cfg, points, gt_boxes, *, seed: int = 666,
               roi_draws=None, on_stage=None):
    """One optimizer step on a batch (``points``: the point tensor, or
    CaDDN's dict of camera inputs); returns the metrics (0-dim tensors,
    ``grad_norm`` the global norm before clipping). ``roi_draws`` replace
    the step's seeded draws; ``on_stage(name)`` is called after each of
    ``STEP_STAGES`` (a grid detector's forward marks its own ``stages``)."""
    mark = on_stage or (lambda name: None)
    model = state.model
    if roi_draws is None and model_api.samples_rois(model_cfg):
        roi_draws = step_roi_draws(model_cfg, points.shape[0], state.step, seed, points.device)
    dropout = None
    if model_api.is_camera_model(model_cfg):
        dropout = step_dropout_generator(state.step, seed, gt_boxes.device)
    for p in model.parameters():
        p.grad = None
    out = model_api.apply_train(model, model_cfg, points, gt_boxes, roi_draws=roi_draws,
                                on_stage=mark, dropout=dropout)
    loss, metrics = model_api.compute_loss(out, gt_boxes, model_cfg,
                                           num_class=int(getattr(model, "num_class", 1)))
    mark("loss")
    loss.backward()
    mark("backward")
    metrics["grad_norm"] = state.optimizer.step()
    mark("optimizer")
    return metrics
