"""The optimizers of the OPTIMIZATION config — port of
``modest_tpu/train/optim.py`` (reference tools/train_utils/optimization/).

``adam_onecycle`` (the flagship's): gradients clipped by their global norm
(optax's rule: scaled by max_norm / norm only when norm >= max_norm, no
epsilon), then Adam with b2 = 0.99, eps = 1e-8 outside the square root and a
scheduled b1 (0.95 → 0.85 → 0.95) whose current value also sets the bias
correction, then decoupled weight decay lr · wd · p on every parameter,
batch-norm scales and biases included (the reference's true_wd, bn_wd).
The learning rate anneals lr_max/div → lr_max over PCT_START of the run,
then down to lr_max/div/1e4, by cosine. ``adam_onecycleflat`` holds the low
rate after FLAT_START; ``adam`` and ``sgd`` couple the weight decay to the
gradient (torch's Adam/SGD). The schedules are read at the optimizer's
step count before each update and computed in float32, as optax does.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def annealing_cos(start, end, pct):
    cos_out = torch.cos(math.pi * pct) + 1
    return end + (start - end) / 2 * cos_out


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def _pow32(base, n: int) -> np.float32:
    """float32(base) ** n, rounded once from float64: XLA's float32 power
    gives these bits (torch's repeated float32 products can be a rounding
    off, which Adam's 1 − b2**n magnifies)."""
    return np.float32(float(np.float32(base)) ** n)


def one_cycle_schedules(lr_max: float, moms, div_factor: float, pct_start: float,
                        total_steps: int):
    """(lr_fn, b1_fn): step → float32 0-dim tensor."""
    low_lr = lr_max / div_factor
    split = int(total_steps * pct_start)

    def cycle(v0, v1, v2):
        def fn(step):
            step = _f32(step)
            up = annealing_cos(v0, v1, step / max(split, 1))
            down = annealing_cos(v1, v2, (step - split) / max(total_steps - split, 1))
            return torch.where(step < split, up, down)

        return fn

    return cycle(low_lr, lr_max, low_lr / 1e4), cycle(moms[0], moms[1], moms[0])


def one_cycle_flat_schedules(lr_max: float, moms, div_factor: float, pct_start: float,
                             flat_start: float, total_steps: int):
    """OneCycleFlat (reference learning_schedules_fastai.py:80-101): cosine up
    to lr_max over PCT_START, back down to lr_max/div by FLAT_START, then
    flat."""
    low_lr = lr_max / div_factor
    s1 = int(total_steps * pct_start)
    s2 = int(total_steps * flat_start)

    def piecewise(v0, v1, v2):
        def fn(step):
            step = _f32(step)
            up = annealing_cos(v0, v1, step / max(s1, 1))
            down = annealing_cos(v1, v2, (step - s1) / max(s2 - s1, 1))
            return torch.where(step < s1, up, torch.where(step < s2, down, _f32(v2)))

        return fn

    return piecewise(low_lr, lr_max, low_lr), piecewise(moms[0], moms[1], moms[0])


def decay_list_schedule(lr: float, decay_step_list, lr_decay: float, lr_clip: float,
                        warmup_steps: int = 0, warmup_eta_min: float = 0.0):
    """Step decay by ``lr_decay`` at each of ``decay_step_list`` (in steps),
    floored at ``lr_clip``, with an optional cosine warm-up (reference
    optimization/__init__.py:40-47 and CosineWarmupLR:103-112)."""
    steps = torch.tensor(sorted(int(s) for s in decay_step_list), dtype=torch.float32)
    floor = float(lr_clip) / float(lr)

    def lr_fn(step):
        step = _f32(step)
        n_passed = (step >= steps).sum().to(torch.float32)
        decay = torch.clamp_min(torch.pow(lr_decay, n_passed), floor) * lr
        if warmup_steps > 0:
            warm = warmup_eta_min + (lr - warmup_eta_min) * (
                1 - torch.cos(math.pi * step / warmup_steps)) / 2
            return torch.where(step < warmup_steps, warm, decay)
        return decay

    return lr_fn


class Optimizer:
    """One of the OPTIMIZATION config's optimizers over ``params``, stepped
    with their ``.grad`` (a parameter without one counts as a zero
    gradient). ``state_dict``/``load_state_dict`` carry the step count and
    the moments for a checkpoint."""

    def __init__(self, params, opt_cfg, total_steps: int, iters_per_epoch: int | None = None):
        self.params = list(params)
        self.name = opt_cfg.OPTIMIZER
        self.max_norm = float(opt_cfg.GRAD_NORM_CLIP)
        self.wd = float(opt_cfg.get("WEIGHT_DECAY", 0.0))
        self.count = 0
        if self.name == "adam_onecycle":
            self.lr_fn, self.b1_fn = one_cycle_schedules(
                float(opt_cfg.LR), tuple(opt_cfg.MOMS), float(opt_cfg.DIV_FACTOR),
                float(opt_cfg.PCT_START), total_steps)
        elif self.name == "adam_onecycleflat":
            self.lr_fn, self.b1_fn = one_cycle_flat_schedules(
                float(opt_cfg.LR), tuple(opt_cfg.MOMS), float(opt_cfg.DIV_FACTOR),
                float(opt_cfg.PCT_START), float(opt_cfg.FLAT_START), total_steps)
        elif self.name in ("adam", "sgd"):
            ipe = iters_per_epoch or max(
                total_steps // max(int(opt_cfg.get("NUM_EPOCHS", 1)), 1), 1)
            if opt_cfg.get("DECAY_STEP_LIST", None):
                warmup = (int(opt_cfg.get("WARMUP_EPOCH", 1)) * ipe
                          if opt_cfg.get("LR_WARMUP", False) else 0)
                self.lr_fn = decay_list_schedule(
                    float(opt_cfg.LR), [int(e) * ipe for e in opt_cfg.DECAY_STEP_LIST],
                    float(opt_cfg.get("LR_DECAY", 0.1)), float(opt_cfg.get("LR_CLIP", 1e-7)),
                    warmup_steps=warmup,
                    warmup_eta_min=float(opt_cfg.LR) / float(opt_cfg.get("DIV_FACTOR", 10)))
            else:
                self.lr_fn = lambda step, lr=float(opt_cfg.LR): _f32(lr)
            self.momentum = float(opt_cfg.get("MOMENTUM", 0.9))
        else:
            raise NotImplementedError(self.name)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params] if self.name != "sgd" else []

    def current_lr(self) -> float:
        """The learning rate the next step applies."""
        return float(self.lr_fn(self.count))

    @torch.no_grad()
    def clip_grads(self):
        """The gradients, clipped by their global norm (optax's
        ``clip_by_global_norm``), and that norm (a device scalar)."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        norm = torch.stack(torch._foreach_norm(grads)).square().sum().sqrt()
        keep = norm < self.max_norm
        one = torch.ones_like(norm)
        grads = torch._foreach_div(grads, torch.where(keep, one, norm))
        torch._foreach_mul_(grads, torch.where(keep, one, one * self.max_norm))
        return grads, norm

    @torch.no_grad()
    def updates(self):
        """The update of every parameter for the current gradients (optax's
        ``updates``; the moments and the step count advance), and the
        gradients' global norm before clipping."""
        grads, norm = self.clip_grads()
        lr = float(self.lr_fn(self.count))
        self.count += 1
        if self.name == "sgd":
            # optax: add_decayed_weights → trace(momentum) → scale by −lr
            torch._foreach_add_(grads, self.params, alpha=self.wd)
            torch._foreach_mul_(self.mu, self.momentum)
            torch._foreach_add_(self.mu, grads)
            return torch._foreach_mul(self.mu, -lr), norm
        if self.name == "adam":  # optax's constants, rounded to float32 where they are used
            torch._foreach_add_(grads, self.params, alpha=self.wd)  # coupled L2
            b1_t, b2 = 0.9, 0.999
            b1, one_minus_b1 = b1_t, 1 - b1_t
        else:  # the scheduled b1, a float32 value
            b1_t, b2 = self.b1_fn(self.count - 1), 0.99
            b1, one_minus_b1 = float(b1_t), float(1 - b1_t)
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, one_minus_b1))
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1 - b2)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, g2)
        # bias corrections under the current b1, in float32
        corr1, corr2 = (float(np.float32(1) - _pow32(b, self.count)) for b in (b1_t, b2))
        den = torch._foreach_div(self.nu, corr2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, 1e-8)
        upd = torch._foreach_div(self.mu, corr1)
        torch._foreach_div_(upd, den)
        if self.name != "adam":  # decoupled weight decay
            torch._foreach_add_(upd, self.params, alpha=self.wd)
        torch._foreach_mul_(upd, -lr)
        return upd, norm

    @torch.no_grad()
    def step(self):
        """One update; returns the gradients' global norm before clipping."""
        upd, norm = self.updates()
        torch._foreach_add_(self.params, upd)
        return norm

    def state_dict(self) -> dict:
        return {"name": self.name, "count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: dict) -> None:
        if state["name"] != self.name or len(state["mu"]) != len(self.mu):
            raise ValueError(f"optimizer state of {state['name']} with {len(state['mu'])} "
                             f"tensors does not fit {self.name} with {len(self.mu)}")
        self.count = int(state["count"])
        for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            dst.copy_(src)


def build_optimizer(params, opt_cfg, total_steps: int, iters_per_epoch: int | None = None):
    """OPTIMIZATION config → ``Optimizer`` over ``params``."""
    return Optimizer(params, opt_cfg, total_steps, iters_per_epoch)
