"""An eval cell: one detector configuration under closed-loop eval traffic.

Set-up makes a pool of batches from the seed by the mix's generator
(``make_batches``) and the weights, builds the reference and the port on
the card, hands both the same weights, and runs every pool batch once
through the timed path. The window then sends one
batch at a time, in pool order, through the port's ``models/api.py``
(``apply_eval`` → ``post_process``) and copies each batch's final boxes,
scores, labels and validity to the host; a batch's latency runs from its
dispatch to that copy. After the window the reference runs the sampled pool
batches and ``compare_batch`` judges the port's last outputs of them.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from . import compare, flops, trace

FINAL_KEYS = ("boxes", "scores", "labels", "valid")


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile."""
    ordered = sorted(values)
    return ordered[max(math.ceil(q / 100 * len(ordered)) - 1, 0)]


class EvalCell:
    def __init__(self, cell, seed: int, device="cuda"):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.cfg, self.recipe, self.mix = cell.config, cell.recipe, cell.traffic
        self.batch, self.pool_size = int(self.mix["batch"]), int(self.mix["pool"])

    # set-up -----------------------------------------------------------------
    def setup(self) -> None:
        from modest_tpu_torch.models import api

        self.api = api
        n = self.recipe.points_per_scan(self.cfg, "test")
        points, gt = self.cell.generator.make_batches(self.seed, self.mix, self.cfg, n)
        self.points = torch.from_numpy(points).to(self.device)
        self.gt_boxes = torch.from_numpy(gt).to(self.device)
        self.reference = self.recipe.build_reference(self.cfg, self.device)
        self.recipe.prepare_weights(self.reference, self.cfg, self.seed, self.points,
                                     self.gt_boxes[0])
        self.port = self.recipe.build_port(self.cfg, self.device)
        missing = self.port.load_state_dict(self.reference.state_dict(), strict=True)
        if missing.missing_keys or missing.unexpected_keys:
            raise RuntimeError(f"state dicts differ: {missing}")
        rng = np.random.default_rng([self.seed, 1])
        self.sampled = sorted(rng.choice(self.pool_size, int(self.mix["compare_batches"]),
                                         replace=False).tolist())
        for i in range(self.pool_size):
            self.run_batch(i)
        self.sync()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # the timed path ---------------------------------------------------------
    def run_batch(self, i: int, clock=None):
        """One batch through the port: (its outputs, its finals on the host)."""
        mcfg = self.port.model_cfg
        if clock is not None:
            clock.begin()
        out = self.api.apply_eval(self.port, mcfg, self.points[i], on_stage=clock)
        final = self.api.post_process(out, mcfg)
        if clock is not None:
            clock("post_process")
        host = {k: final[k].cpu() for k in FINAL_KEYS}
        if clock is not None:
            clock.end()
        return out, host

    def window(self, seconds: float, traced: bool = False) -> dict:
        """Closed-loop batches for ``seconds``, and at least one pass through
        the pool; with ``traced``, stage events on every batch and
        ``torch.profiler`` over the second pass through the pool."""
        stages = tuple(getattr(self.port, "stages", self.recipe.STAGES))
        order = (*stages, "post_process", "host_copy")
        clock = trace.StageClock(stages[0], dict(zip(order, order[1:])), ranges=traced)
        self.kept = {}
        latencies, failed = [], 0
        prof, prof_events = None, None
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.sync()
        t0 = time.perf_counter()
        i = 0
        while True:
            p = i % self.pool_size
            if traced and i == self.pool_size:
                prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                          torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
                span = torch.profiler.record_function("bench:profiled")
                span.__enter__()
            t = time.perf_counter()
            out, host = self.run_batch(p, clock if traced else None)
            latencies.append(time.perf_counter() - t)
            failed += int(not (torch.isfinite(host["boxes"]).all()
                               and torch.isfinite(host["scores"]).all()))
            if p in self.sampled:
                self.kept[p] = (out, host)
            i += 1
            if prof is not None and prof_events is None and i == 2 * self.pool_size:
                span.__exit__(None, None, None)
                prof.__exit__(None, None, None)
                prof_events = trace.export_events(prof)
                prof = None
            done = i >= (2 if traced else 1) * self.pool_size
            if done and time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        self.memory_peak = (torch.cuda.max_memory_allocated(self.device)
                            if self.device.type == "cuda" else 0)
        missing = [p for p in self.sampled if p not in self.kept]
        if missing:
            raise RuntimeError(f"the window never ran pool batches {missing}")
        result = {"batches": i, "seconds": elapsed, "latencies": latencies, "failed": failed,
                  "clock": clock}
        if prof_events is not None:
            result["profile"] = trace.reduce_profile(
                prof_events, trace.span_of(prof_events, "bench:profiled"))
        return result

    # the comparison ---------------------------------------------------------
    def release_port(self) -> None:
        del self.port
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_outputs(self, tf32: bool = False, count_flops: bool = False):
        """The reference's outputs and finals of each sampled batch, with
        TF32 on for the control; with ``count_flops``, also the mean FLOPs."""
        from bench_h100.reference import sparse_conv

        matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        try:
            outs, total = {}, 0
            for p in self.sampled:
                def forward(p=p):
                    outs[p] = self.recipe.reference_eval(self.reference, self.cfg,
                                                          self.points[p])
                if count_flops:
                    total += flops.count(self.reference, forward, sparse_conv)
                else:
                    forward()
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn
        return outs, (total / len(self.sampled) if count_flops else None)

    def numbers(self, got: dict, want: dict) -> dict[str, float]:
        """The compared numbers of ``got`` (pool index → (outputs, finals))
        against ``want``, over the sampled batches."""
        tally = compare.Tally()
        for p in self.sampled:
            self.recipe.compare_batch(tally, got[p][0], got[p][1], want[p][0], want[p][1])
        return tally.numbers()
