"""The card's peaks and the roofline arithmetic, frozen copies of
``chip_smoke.py``'s ``PEAK_F32_FLOPS``, ``PEAK_BYTES_PER_S``,
``FPS_OPS_PER_POINT_STEP``, ``fps_bound`` and the bound of an operation
count and a byte count.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of HBM3.
"""
from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# FPS work per point and step: 3 sub, 3 mul, 2 add, 1 min, 1 compare
FPS_OPS_PER_POINT_STEP = 10


def bound(ops: float, nbytes: float):
    """(least ms at the peaks, "operations" or "bytes": which one bounds it)."""
    t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def fps_bound(b: int, n: int, npoint: int):
    """Least ms of FPS on ``b`` clouds of ``n`` points taking ``npoint``:
    every step updates every point's distance; each point read once, each
    index written once."""
    ops = b * max(npoint - 1, 0) * n * FPS_OPS_PER_POINT_STEP
    nbytes = b * n * 3 * 4 + b * npoint * 4
    return bound(ops, nbytes)
