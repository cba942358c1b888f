"""A train cell: one detector configuration trained step after step, fed by
the program's loader.

Set-up writes the mix's training scans from the seed (the mix's generator,
``write_dataset``) into a directory under the run's ``TMPDIR``, makes their
infos and gt database with the program's own preparation
(``data/kitti_dataset.py::create_kitti_infos``), and builds the program's
loader over them as ``cli/train.py`` does (``data/loader.py::build_dataloader``
with the mix's workers, the loader's seed from the run's). Batches reach the
card through ``prefetch_to_device``, one epoch after another, as
``train/loop.py::train_model`` feeds them. The weights come from the seed
(SECOND's heads calibrated over the loader's first epoch). Set-up builds the
port's model and its ``TrainState`` (the configuration's optimizer, its
one-cycle laid over the mix's schedule) and drives that state through its
first ``check_steps`` steps with the window's own call and feed, keeping
their batches, the losses, the optimizer's first moments after the first
step and the weights before and after. The window carries the same state on,
reading each step's metrics back to the host as ``train_model`` does. At one
window step drawn from the seed it copies the weights and the optimizer's
state before the step (the copy's time is taken out of the window) and keeps
the batch, the step's metrics, and the weights and first moments after it.
After the window the reference follows the first steps from the same weights
and batches, and takes the drawn step from the copy; ``numbers`` judges the
port's readings against it.
"""
from __future__ import annotations

import atexit
import contextlib
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from . import flops, trace


def leaf_gaps(got: dict, want: dict, keep) -> float:
    """The worst leaf's gap between two sets of per-leaf norms, against the
    larger of that leaf's reference norm and the median leaf's."""
    ref = torch.tensor([want[k] for k in keep])
    median = float(ref.median()) if len(ref) else 0.0
    gaps = [abs(got[k] - want[k]) / max(want[k], median, 1e-30) for k in keep]
    return max(gaps) if gaps else 0.0


def moment_decay(opt, count: int) -> float:
    """The first moment's decay in the update after ``count`` steps: the
    scheduled b1 of the configurations' one-cycle Adam."""
    return float(opt.b1_fn(count))


def gradient_norms(mu_before: dict, mu_after: dict, b1: float) -> dict:
    """Each leaf's norm of the gradient as Adam got it in one update:
    (mu_after − b1 · mu_before) / (1 − b1), the moments by leaf name."""
    return {k: float(((a - b1 * mu_before[k]) / (1 - b1)).norm()) for k, a in mu_after.items()}


def change_norms(before: dict, after: dict) -> dict:
    return {k: float((after[k] - before[k]).norm()) for k in after}


class TrainCell:
    def __init__(self, cell, seed: int, device="cuda"):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.cfg, self.recipe, self.mix = cell.config, cell.recipe, cell.traffic
        self.batch = int(self.mix["batch"])
        self.pool_size = int(self.mix["scans"]) // self.batch  # steps an epoch
        self.check_steps = int(self.mix["check_steps"])
        self.total_steps = int(self.cfg["OPTIMIZATION"]["NUM_EPOCHS"]) * (
            int(self.mix["schedule_scans"]) // self.batch)
        rng = np.random.default_rng([seed, 2])
        self.window_step = int(rng.integers(1, int(self.mix["compare_within"])))
        self.loader = None

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # set-up -----------------------------------------------------------------
    def setup(self) -> None:
        from modest_tpu_torch.data.kitti_dataset import create_kitti_infos
        from modest_tpu_torch.data.loader import build_dataloader, prefetch_to_device
        from modest_tpu_torch.train import state as train_state
        from modest_tpu_torch.utils.config import Config

        self.train_state, self.prefetch = train_state, prefetch_to_device
        self.root = Path(tempfile.mkdtemp(prefix="bench_h100_"))
        atexit.register(shutil.rmtree, self.root, True)
        self.cell.generator.write_dataset(self.root, self.seed, self.mix, self.cfg)
        cfg = Config(self.cfg)
        cfg.DATA_CONFIG.DATA_PATH = str(self.root)
        names = list(cfg.CLASS_NAMES)
        with contextlib.redirect_stdout(sys.stderr):
            create_kitti_infos(cfg.DATA_CONFIG, names, self.root, self.root, if_val=False)
            _, self.loader = build_dataloader(cfg.DATA_CONFIG, names, self.batch, training=True,
                                              num_workers=int(self.mix["workers"]))
        self.loader.seed = self.seed % 2 ** 31
        if len(self.loader) != self.pool_size:
            raise RuntimeError(f"the loader gives {len(self.loader)} batches an epoch, "
                               f"not {self.pool_size}")
        first = list(self.prefetch(self.loader, self.device))
        reference = self.recipe.build_reference(self.cfg, self.device)
        self.recipe.prepare_weights(reference, self.cfg, self.seed,
                                    torch.stack([b["points"] for b in first]),
                                    first[0]["gt_boxes"])
        del first
        self.initial = {k: v.detach().clone() for k, v in reference.state_dict().items()}
        del reference
        self.port = self.recipe.build_port(self.cfg, self.device)
        self.port.load_state_dict(self.initial, strict=True)
        self.state = train_state.create_train_state(self.port, Config(self.cfg["OPTIMIZATION"]),
                                                    self.total_steps)
        self.names = [k for k, _ in self.port.named_parameters()]
        self.feed = self.batches()
        self.checked, self.port_losses = [], []
        for i in range(self.check_steps):
            batch = next(self.feed)
            self.checked.append((batch["points"], batch["gt_boxes"]))
            metrics = self.step(batch)
            self.port_losses.append(metrics["loss"])
            if i == 0:
                self.port_moment = {k: float(m.norm())
                                    for k, m in zip(self.names, self.state.optimizer.mu)}
                self.port_first_change = {k: float((p.detach() - self.initial[k]).norm())
                                          for k, p in self.port.named_parameters()}
        self.port_change = {k: float((p.detach() - self.initial[k]).norm())
                            for k, p in self.port.named_parameters()}
        self.sync()

    def batches(self):
        """The loader's batches on the card, one epoch after another."""
        epoch = 0
        while True:
            self.loader.set_epoch(epoch)
            yield from self.prefetch(self.loader, self.device)
            epoch += 1

    # the timed path ---------------------------------------------------------
    def step(self, batch: dict, clock=None) -> dict:
        """One step of the port on ``batch``: the metrics on the host."""
        if clock is not None:
            clock.begin()
        out = self.train_state.train_step(self.state, self.port.model_cfg, batch["points"],
                                          batch["gt_boxes"], seed=self.seed, on_stage=clock)
        keys = list(out)
        values = torch.stack([out[k].detach().float() for k in keys]).tolist()
        if clock is not None:
            clock.end()
        return dict(zip(keys, values))

    def snapshot(self) -> dict:
        opt = self.state.optimizer
        return {"state": {k: v.detach().clone() for k, v in self.port.state_dict().items()},
                "count": int(opt.count), "mu": self.by_name(opt.mu), "nu": self.by_name(opt.nu)}

    def by_name(self, tensors) -> dict:
        """Copies of the optimizer's per-parameter tensors, by leaf name."""
        return {k: t.clone() for k, t in zip(self.names, tensors)}

    def window(self, seconds: float, traced: bool = False) -> dict:
        stages = (*tuple(getattr(self.port, "stages", self.recipe.STAGES)),
                  "loss", "backward", "optimizer")
        clock = trace.StageClock(stages[0], dict(zip(stages, stages[1:])), ranges=traced)
        failed, steps, prof, prof_events, latencies, waits = 0, 0, None, None, [], []
        span, aside = None, 0.0
        k = self.window_step
        if traced and self.pool_size <= k < 2 * self.pool_size:
            k += self.pool_size  # the compared step stays out of the profiled pass
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.sync()
        t0 = time.perf_counter()
        while True:
            if traced and steps == self.pool_size:
                prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                          torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
                span = torch.profiler.record_function("bench:profiled")
                span.__enter__()
            t = time.perf_counter()
            with (torch.profiler.record_function("stage:data_wait") if traced
                  else contextlib.nullcontext()):
                batch = next(self.feed)
            waits.append(time.perf_counter() - t)
            if steps == k:
                t_aside = time.perf_counter()
                before = self.snapshot()
                self.sync()
                aside += time.perf_counter() - t_aside
            t_step = time.perf_counter()
            metrics = self.step(batch, clock if traced else None)
            latencies.append(time.perf_counter() - t_step + waits[-1])
            if steps == k:
                t_aside = time.perf_counter()
                self.at_step = {"before": before, "batch": (batch["points"], batch["gt_boxes"]),
                                "loss": metrics["loss"],
                                "params": {n: p.detach().clone()
                                           for n, p in self.port.named_parameters()},
                                "mu": self.by_name(self.state.optimizer.mu)}
                self.sync()
                aside += time.perf_counter() - t_aside
            failed += int(not all(v == v and abs(v) != float("inf") for v in metrics.values()))
            steps += 1
            if prof is not None and prof_events is None and steps == 2 * self.pool_size:
                span.__exit__(None, None, None)
                prof.__exit__(None, None, None)
                prof_events = trace.export_events(prof)
                prof = None
            done = steps >= (2 if traced else 1) * self.pool_size and steps > k
            if done and time.perf_counter() - t0 - aside >= seconds:
                break
        elapsed = time.perf_counter() - t0 - aside
        self.memory_peak = (torch.cuda.max_memory_allocated(self.device)
                            if self.device.type == "cuda" else 0)
        result = {"batches": steps, "seconds": elapsed, "failed": failed, "clock": clock,
                  "latencies": latencies, "waits": waits}
        if prof_events is not None:
            result["profile"] = trace.reduce_profile(
                prof_events, trace.span_of(prof_events, "bench:profiled"))
        return result

    def release_port(self) -> None:
        """Free the port's model and state, stop the loader's workers and
        remove the written scans."""
        del self.state, self.port, self.feed
        if self.loader is not None:
            self.loader.close()
            self.loader = None
        shutil.rmtree(self.root, ignore_errors=True)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # the comparison ---------------------------------------------------------
    def reference_readings(self, tf32: bool = False, count_flops: bool = False,
                           half_batch: bool = False) -> dict:
        """The reference's losses, first moments and weight changes over the
        first steps from the same weights and batches, and its step from the
        copy taken before the window's drawn step, on that step's batch
        (TF32 on for the control; ``half_batch`` plants the fault of a step
        that computes half of each batch and repeats it for the rest)."""
        from bench_h100.reference import sparse_conv
        from bench_h100.reference import train as ref_train

        cap = self.recipe.max_voxels(self.cfg, "train") if hasattr(
            self.recipe, "max_voxels") else None

        def feed(points, gt):
            if half_batch:
                h = points.shape[0] // 2
                points, gt = torch.cat([points[:h]] * 2), torch.cat([gt[:h]] * 2)
            return points, gt

        matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        try:
            model = self.recipe.build_reference(self.cfg, self.device)
            model.load_state_dict(self.initial)
            opt = ref_train.optimizer(model, self.cfg, self.total_steps)
            names = [k for k, _ in model.named_parameters()]
            losses, moment, fl = [], {}, None
            for i, (points, gt) in enumerate(self.checked):
                points, gt = feed(points, gt)

                def run(points=points, gt=gt):
                    return ref_train.train_step(model, opt, points, gt, seed=self.seed,
                                                max_voxels=cap)
                if count_flops and i == 0:
                    counter = flops.FlopCounter()
                    with counter.counting(model, sparse_conv):
                        metrics = run()
                    fl = 3 * counter.flops  # the backward counted as twice the forward
                else:
                    metrics = run()
                losses.append(metrics["loss"])
                if i == 0:
                    moment = {k: float(m.norm()) for k, m in zip(names, opt.mu)}
                    first_change = {k: float((p.detach() - self.initial[k]).norm())
                                    for k, p in model.named_parameters()}
            change = {k: float((p.detach() - self.initial[k]).norm())
                      for k, p in model.named_parameters()}

            # the window's drawn step, from the port's state before it
            before = self.at_step["before"]
            model.load_state_dict(before["state"])
            opt = ref_train.optimizer(model, self.cfg, self.total_steps)
            opt.load_state_dict({"name": opt.name, "count": before["count"],
                                 "mu": [before["mu"][k] for k in names],
                                 "nu": [before["nu"][k] for k in names]})
            metrics = ref_train.train_step(model, opt, *feed(*self.at_step["batch"]),
                                           seed=self.seed, max_voxels=cap)
            b1 = moment_decay(opt, before["count"])
            step_grad = gradient_norms(before["mu"], dict(zip(names, opt.mu)), b1)
            step_change = change_norms(before["state"],
                                       {k: p.detach() for k, p in model.named_parameters()})
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn
        return {"losses": losses, "moment": moment, "first_change": first_change,
                "change": change, "flops": fl, "step_loss": metrics["loss"],
                "step_grad": step_grad, "step_change": step_change, "b1": b1}

    def port_readings(self, b1: float) -> dict:
        """The port's readings; ``b1`` is the first moment's decay in the
        drawn step's update (``reference_readings`` works it out)."""
        at = self.at_step
        return {"losses": self.port_losses, "moment": self.port_moment,
                "first_change": self.port_first_change, "change": self.port_change,
                "step_loss": at["loss"],
                "step_grad": gradient_norms(at["before"]["mu"], at["mu"], b1),
                "step_change": change_norms(at["before"]["state"], at["params"])}

    @staticmethod
    def numbers(got: dict, want: dict) -> dict[str, float]:
        """Compared (``workloads/<cell>.json``): the first step's loss against
        the reference's (relative gap), the worst leaf's gap of the first
        moment after it (the first gradient as the optimizer gets it), and
        the worst leaf's gap of the weights' change in that step; then the
        same three of the window's drawn step, taken from the same state on
        both sides: its loss, the worst leaf's gap of its gradient as Adam
        got it (worked out from the first moments before and after), and of
        its change. Read besides (PERF.md says why they are not compared):
        the losses' widest gap over the checked steps, the median leaf's gap
        of the first step's change, and the median and the worst leaf's gap
        of the change over the checked steps. A leaf's gap is against the
        larger of its own and the median leaf's reference norm. Leaves whose
        gradient in the reference is under a thousandth of the median leaf's
        (nought to rounding, as a key's bias under softmax) are left out:
        by the first moment for the first step, by the step's gradient for
        the drawn step."""
        def kept(norms: dict) -> list:
            floor = 1e-3 * float(torch.tensor(list(norms.values())).median())
            return [k for k, v in norms.items() if v >= floor]

        keep, keep_step = kept(want["moment"]), kept(want["step_grad"])

        def rel(g, w):
            return abs(g - w) / max(abs(w), 1e-30)

        def gaps(key, leaves):
            norms = torch.tensor([want[key][k] for k in leaves])
            median = float(norms.median()) if len(norms) else 0.0
            return sorted(abs(got[key][k] - want[key][k]) / max(want[key][k], median, 1e-30)
                          for k in leaves) or [0.0]

        first, change = gaps("first_change", keep), gaps("change", keep)
        return {"first_loss_gap": rel(got["losses"][0], want["losses"][0]),
                "moment_gap": leaf_gaps(got["moment"], want["moment"], keep),
                "first_change_gap": first[-1],
                "step_loss_gap": rel(got["step_loss"], want["step_loss"]),
                "step_grad_gap": leaf_gaps(got["step_grad"], want["step_grad"], keep_step),
                "step_change_gap": gaps("step_change", keep_step)[-1],
                "first_change_median_gap": first[len(first) // 2],
                "loss_gap": max(rel(g, w) for g, w in zip(got["losses"], want["losses"])),
                "median_change_gap": change[len(change) // 2],
                "change_gap": change[-1]}
