"""Epoch-level training loop — port of ``modest_tpu/train/loop.py``
(reference tools/train_utils/train_utils.py). The eval loop
(``eval_one_epoch``) comes with the detection-eval slice.

Each step's metrics are read back to the host once per step (one
synchronisation), so every step's loss is logged and checked; with
``stage_times`` each step also records CUDA-event times of its stages.
"""
from __future__ import annotations

import time

import torch

from ..data.loader import prefetch_to_device
from .state import train_step


class _StageEvents:
    """CUDA events at the boundaries of one step's stages."""

    def __init__(self):
        self.events = []

    def mark(self, name: str):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append((name, ev))

    def ms(self) -> dict:
        """Milliseconds per stage; call after the step's work has finished."""
        pairs = zip(self.events, self.events[1:])
        return {name: a.elapsed_time(b) for (_, a), (name, b) in pairs}


def train_model(state, model_cfg, loader, *, device, start_epoch: int, total_epochs: int,
                ckpt_manager=None, ckpt_save_interval: int = 1, logger=None,
                seed: int = 666, log_interval: int = 50,
                merge_all_iters_to_one_epoch: bool = False, metrics_logger=None,
                stage_times: bool = False):
    """Train ``state`` from ``start_epoch`` to ``total_epochs``, saving a
    checkpoint after every ``ckpt_save_interval``-th epoch. Returns one
    record per step: epoch, step, metrics (floats), ``data_wait_ms`` (host
    time waiting for the batch), ``end_s`` (host clock after the step's
    metrics were read) and, with ``stage_times`` on a CUDA device,
    ``stage_ms`` by CUDA events (``state.STEP_STAGES``)."""
    log = logger.info if logger else print
    timed = stage_times and torch.device(device).type == "cuda"
    history = []

    def run_epoch(epoch, batches, its_this_epoch):
        t0 = time.perf_counter()
        metrics = {}
        for n_it in range(1, its_this_epoch + 1):
            t_wait = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            data_wait_ms = (time.perf_counter() - t_wait) * 1e3
            events = _StageEvents() if timed else None
            if events:
                events.mark("start")
            step, lr = state.step, state.optimizer.current_lr()
            out = train_step(state, model_cfg, batch["points"], batch["gt_boxes"], seed=seed,
                             on_stage=events.mark if events else None)
            keys = list(out)
            metrics = dict(zip(keys, torch.stack([out[k].float() for k in keys]).tolist()))
            rec = {"epoch": epoch, "step": step, "metrics": metrics,
                   "data_wait_ms": data_wait_ms, "end_s": time.perf_counter()}
            if events:
                rec["stage_ms"] = events.ms()
            history.append(rec)
            if metrics_logger is not None:
                metrics_logger.log(step, {**metrics, "lr": lr}, prefix="train/")
            if n_it % log_interval == 0:
                log(f"epoch {epoch} it {n_it}/{its_this_epoch} loss {metrics['loss']:.4f} "
                    f"lr {lr:.6f}")
        log(f"epoch {epoch} done in {time.perf_counter() - t0:.1f}s "
            + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
        if ckpt_manager is not None and (epoch + 1) % ckpt_save_interval == 0:
            ckpt_manager.save(state, epoch + 1)

    if merge_all_iters_to_one_epoch:
        # the merged dataset holds total_epochs × N samples: one pass over
        # the loader is the whole run, checkpointed every len/total_epochs
        # steps (reference train_utils.train_model)
        its_per_epoch = max(len(loader) // max(total_epochs, 1), 1)
        loader.set_epoch(0)
        batches = prefetch_to_device(loader, device)
        for _ in range(start_epoch * its_per_epoch):  # resume: skip what was consumed
            next(batches, None)
        for epoch in range(start_epoch, total_epochs):
            run_epoch(epoch, batches, its_per_epoch)
    else:
        for epoch in range(start_epoch, total_epochs):
            loader.set_epoch(epoch)
            run_epoch(epoch, prefetch_to_device(loader, device), len(loader))
    return history

