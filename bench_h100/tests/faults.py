"""Faults planted in the port underneath a run, and the CPU-sized runs that
drive the harness over them (the look for a card skipped).

Eval faults: an eval step that hands back its first answer whatever it is
given (its state unchanged), half of each batch left out (the port computes
the first half and hands it back for the rest), one answer altered where it
is produced (the first scan's final boxes moved by 5 cm). Train faults: a
step that leaves its state unchanged (the optimizer applies no update), half
of each batch left out (the port trains on the first half, repeated for the
rest), one answer altered where it is produced (the reported loss moved by
one part in a thousand); and two that start only once set-up's checked steps
are done, so that only the window's drawn step can see them: an optimizer
that stops applying its updates, and a step that hands back the last
metrics it computed and runs nothing. A cell on one card has no exchange
between cards to leave out.
"""
from __future__ import annotations

import torch

from bench_h100 import run as bench_run
from conftest import add_tiny_cell


def stale_answer(monkeypatch):
    from modest_tpu_torch.models import api

    post_process, first = api.post_process, []

    def stale(out, cfg):
        final = post_process(out, cfg)
        if not first:
            first.append(final)
        return first[0]

    monkeypatch.setattr(api, "post_process", stale)


def eval_half_batch(monkeypatch):
    from modest_tpu_torch.models import api

    apply_eval = api.apply_eval

    def half(model, cfg, points, on_stage=None):
        kept = points[: points.shape[0] // 2]
        return apply_eval(model, cfg, torch.cat([kept, kept]), on_stage=on_stage)

    monkeypatch.setattr(api, "apply_eval", half)


def eval_altered_answer(monkeypatch):
    from modest_tpu_torch.models import api

    post_process = api.post_process

    def altered(out, cfg):
        final = post_process(out, cfg)
        boxes = final["boxes"].clone()
        boxes[0, :, 0] += 0.05
        return {**final, "boxes": boxes}

    monkeypatch.setattr(api, "post_process", altered)


# the configurations, PointRCNN at 4096 points a scan to keep the CPU's share small
CONFIGS = {"pointrcnn_dynamic_obj": 4096, "second_dynamic_obj": None}


def tiny_eval_run(bench_tree, config, seed, pool=1):
    tree, manifest_path, bench = bench_tree
    name = add_tiny_cell(tree, bench, manifest_path, config, batch=2, pool=pool, compare=pool,
                         points=CONFIGS[config])
    return bench_run.run(["--workload", name, "--seed", str(seed), "--seconds", "0"],
                         device="cpu", benchmark=manifest_path, bench_dir=tree)


def unchanged_state(monkeypatch):
    from modest_tpu_torch.train import optim

    def no_update(self):
        _, norm = self.updates()
        return norm

    monkeypatch.setattr(optim.Optimizer, "step", no_update)


def skipped_update_after_warmup(monkeypatch, after: int = 2):
    from modest_tpu_torch.train import optim

    step = optim.Optimizer.step

    def skipping(self):
        if self.count < after:
            return step(self)
        _, norm = self.updates()
        return norm

    monkeypatch.setattr(optim.Optimizer, "step", skipping)


def cached_step_after_warmup(monkeypatch, after: int = 2):
    from modest_tpu_torch.train import state

    train_step, seen = state.train_step, []

    def cached(*args, **kwargs):
        if len(seen) < after:
            seen.append(train_step(*args, **kwargs))
        return seen[-1]

    monkeypatch.setattr(state, "train_step", cached)


def train_half_batch(monkeypatch):
    from modest_tpu_torch.models import api

    apply_train = api.apply_train

    def half(model, cfg, points, gt_boxes, **kwargs):
        h = points.shape[0] // 2
        return apply_train(model, cfg, torch.cat([points[:h]] * 2),
                           torch.cat([gt_boxes[:h]] * 2), **kwargs)

    monkeypatch.setattr(api, "apply_train", half)


def train_altered_answer(monkeypatch):
    from modest_tpu_torch.train import state

    train_step = state.train_step

    def altered(*args, **kwargs):
        metrics = train_step(*args, **kwargs)
        return {**metrics, "loss": metrics["loss"] * 1.001}

    monkeypatch.setattr(state, "train_step", altered)


def tiny_train_run(bench_tree):
    tree, manifest_path, bench = bench_tree
    name = add_tiny_cell(tree, bench, manifest_path, "pointrcnn_dynamic_obj", batch=2, pool=2,
                         compare=2, points=4096, mode="train")
    return bench_run.run(["--workload", name, "--seed", str(2 ** 31 + 33), "--seconds", "0"],
                         device="cpu", benchmark=manifest_path, bench_dir=tree)
