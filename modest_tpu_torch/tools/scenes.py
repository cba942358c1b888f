"""Synthetic lidar scans for driving the detector without a dataset."""
from __future__ import annotations

import numpy as np


def bench_scans(b: int, n: int, seed: int) -> np.ndarray:
    """bench.py's scene recipe as (b, n, 4) float32 (x, y, z, intensity):
    x in [0, 80], y in ±40, z around the ground, and ten car-sized clusters
    of 300 points each per scan, all from one numpy seed."""
    rng = np.random.RandomState(seed)
    points = rng.uniform(0, 1, (b, n, 4)).astype(np.float32)
    points[..., 0] = points[..., 0] * 80
    points[..., 1] = (points[..., 1] - 0.5) * 80
    points[..., 2] = (points[..., 2] - 0.5) * 3 - 0.5
    for i in range(b):
        for k in range(10):
            c = rng.uniform([5, -30, -1.6], [70, 30, -1.4])
            points[i, k * 300:(k + 1) * 300, :3] = c + rng.uniform(-1, 1, (300, 3)) * [2, 0.9, 0.7]
    return points
