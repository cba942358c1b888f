"""The whole train step's share of the card's float32 peak: three times the
analytic FLOPs of the step's forward (the backward counted as twice the
forward; harness/flops.py, on the reference's first step at the cell's own
shapes) over a step's mean host time in the window, against 67 TFLOP/s."""
from bench_h100.harness.peaks import PEAK_F32_FLOPS

LAYER = "whole train step"
MOVES = "train_scans_per_s"


def read(ctx):
    if not ctx.flops_per_batch or not ctx.batch_s:
        return None
    return ctx.flops_per_batch / ctx.batch_s / PEAK_F32_FLOPS * 100
