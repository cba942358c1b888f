"""Inputs that hold the masked ball-query kernel (``csrc/ball_query.cu``) to
its plain twin (``ops/pointnet2_stack.py::ball_query_masked_plain``): scans
like the benchmark's PV-RCNN pool with their keypoints and RoI grid points
at the cell's raw-point and grid-pool shapes, and adversarial shells whose
plain squared distances lie within a few ulps of r².
``tests/test_torch_ball_query_kernel.py`` and ``chip_smoke.py``'s phase
``ball_query_vs_plain`` share them.

Every cloud is made with numpy from a fixed seed; the keypoints come from
the FPS of the caller's device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.pv_rcnn import roi_grid_points
from ..ops.pointnet2 import furthest_point_sample, gather_points
from .scenes import bench_scans

# PV-RCNN on Lyft (pv_rcnn_dynamic_obj.yaml): 65536 points a scan, 2048
# keypoints, the raw points' radii and nsamples, the RoI-grid pool's over
# 100 RoIs a scan with 6^3 grid points each
POINTS, KEYPOINTS, ROIS, GRID = 65536, 2048, 100, 6
RAW_QUERIES = ((0.4, 16), (0.8, 16))
GRID_QUERIES = ((0.8, 16), (1.6, 16))
CAR = ((3.5, 1.6, 1.4), (5.0, 2.2, 1.8))  # the RoIs' sizes, low and high


def scan_clouds(b: int, n: int, seed: int, device) -> tuple:
    """(xyz (b, n, 3), mask (b, n) all set, keypoints (b, KEYPOINTS, 3)) on
    ``device``: ``tools/scenes.py::bench_scans`` points (ground and
    car-sized clusters, x in [0, 80], y in ±40), keypoints by FPS."""
    xyz = torch.as_tensor(bench_scans(b, n, seed)[..., :3], device=device).contiguous()
    kp = gather_points(xyz, furthest_point_sample(xyz, KEYPOINTS)).contiguous()
    return xyz, torch.ones(b, n, dtype=torch.bool, device=device), kp


def grid_centres(keypoints, seed: int):
    """(B, ROIS · GRID³, 3): the RoI-grid points of ROIS car-sized boxes a
    scan, each centred on a keypoint drawn from ``seed``, turned by a
    heading drawn from it."""
    rng = np.random.RandomState(seed)
    b = keypoints.shape[0]
    pick = torch.as_tensor(rng.randint(0, keypoints.shape[1], (b, ROIS)), device=keypoints.device)
    size = rng.uniform(CAR[0], CAR[1], (b, ROIS, 3)).astype(np.float32)
    heading = rng.uniform(-np.pi, np.pi, (b, ROIS, 1)).astype(np.float32)
    rois = torch.cat([torch.gather(keypoints, 1, pick[..., None].expand(-1, -1, 3)),
                      torch.as_tensor(np.concatenate([size, heading], -1),
                                      device=keypoints.device)], -1)
    return roi_grid_points(rois, GRID).reshape(b, ROIS * GRID ** 3, 3).contiguous()


def shells(seed: int, b: int, m: int, n: int, radius: float, origin, mask_share: float = 0.1):
    """Numpy (xyz (b, n, 3), mask (b, n), centres (b, m, 3)), float32: the m
    centres of a cloud within 1e-6 of ``origin`` and its n sources on the
    sphere of ``radius`` around it, each at radius · (1 ± 4e-7), so every
    pair's d² lies within rounding of r²; ``mask_share`` of the sources
    masked. Near the origin the plain twin's d² falls a few ulps either side
    of r²; far from it, the rounding of |c|² + |s|² − 2 c·s decides the
    membership of about every pair."""
    rng = np.random.RandomState(seed)
    origin = np.asarray(origin, np.float64)
    centres = origin + rng.uniform(-1e-6, 1e-6, (b, m, 3))
    way = rng.normal(size=(b, n, 3))
    way /= np.linalg.norm(way, axis=-1, keepdims=True)
    dist = radius * (1 + rng.uniform(-4e-7, 4e-7, (b, n, 1)))
    xyz = origin + way * dist
    mask = rng.uniform(size=(b, n)) >= mask_share
    return xyz.astype(np.float32), mask, centres.astype(np.float32)
