"""Train state and one optimizer step — port of ``modest_tpu/train/state.py``.

A step is: forward in train mode, loss, backward, gradient clipping and the
update (``train/optim.py``). The RoI sampler of the detectors that sample RoIs
(``models/api.py::SAMPLES_ROIS``: PointRCNN, PVRCNN, VoxelRCNN, PartA2) draws
at step ``s`` from a ``torch.Generator`` seeded from (seed, s), as JAX folds
the step into its "sampler" key, so a resumed run draws as the
uninterrupted one would; so does CaDDN's DeepLab ASPP dropout, on the
device; the others (the grid detectors, SECOND-IoU) draw nothing.

In a process group (``parallel/``) a step is the JAX package's one sharded
step over the global batch: the draws are made for the global batch and each
process takes its rows, the batch norms and the loss normalizers span the
global batch, each process's loss is its share of the global loss, and the
gradients are summed over the processes before the update (clipping sees the
global norm); the logged losses are the shares summed.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models import api as model_api
from ..models.pointrcnn import STAGES
from ..models.roi_head import sampler_draws
from ..parallel.mesh import distributed, global_batch, global_sum, rank_rows, reduce_gradients
from .optim import Optimizer, build_optimizer

# the forward's stages (in train mode "roi_pool" includes the RoI sampling),
# then the rest ("grad_reduce" in a process group only)
STEP_STAGES = (*STAGES, "loss", "backward", "grad_reduce", "optimizer")
# the metrics that are already the global batch's (counts summed by
# ``global_sum``); every other metric of a loss is this process's share
GLOBAL_METRICS = ("point_pos_num",)


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
    ``STEP_STAGES`` (a grid detector's forward marks its own ``stages``).
    In a process group the losses are the global batch's (the shares summed
    over the processes)."""
    mark = on_stage or (lambda name: None)
    model = state.model
    if roi_draws is None and model_api.samples_rois(model_cfg):
        b = points.shape[0]
        draws = step_roi_draws(model_cfg, global_batch(b), state.step, seed, points.device)
        roi_draws = {k: rank_rows(v, b) for k, v in draws.items()}
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
    if distributed():
        reduce_gradients(model.parameters())
        shares = [k for k in metrics if k not in GLOBAL_METRICS]
        summed = global_sum(torch.stack([metrics[k].detach().float() for k in shares]))
        metrics.update(zip(shares, summed.unbind()))
        mark("grad_reduce")
    metrics["grad_norm"] = state.optimizer.step()
    mark("optimizer")
    return metrics
