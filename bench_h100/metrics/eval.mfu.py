"""The whole eval step's share of the card's float32 peak: the analytic
FLOPs of one batch (harness/flops.py, counted on the reference at the
batch's own shapes and voxels) over a batch's mean host time in the window,
against 67 TFLOP/s."""
from bench_h100.harness.peaks import PEAK_F32_FLOPS

LAYER = "whole model step"
MOVES = "eval_scans_per_s"


def read(ctx):
    if not ctx.flops_per_batch or not ctx.batch_s:
        return None
    return ctx.flops_per_batch / ctx.batch_s / PEAK_F32_FLOPS * 100
