"""Full-density Lyft-like lidar scans, made in memory from a seed.

A frozen copy of the port's ``tools/synth_kitti.py::make_dataset`` frame
recipe at ``full_density`` (60000 ground points over x 2–80 m, y ±30 m; 8–20
``Dynamic`` car-sized boxes of 1500 points each, ahead of the sensor), with
the Lyft dataset's test-time point handling copied from the port's
``utils/kitti_io.py::get_fov_flag`` (the synthetic camera: P2 focal 700,
1200 × 400 image, lidar x forward) and ``data/processor.py``
(``mask_points_and_boxes_outside_range``, ``sample_points``). Every draw
comes from one ``numpy.random.Generator`` seeded by the run's seed, so the
same seed gives the same scans.

Entry point of an eval mix: ``make_batches(seed, mix, cfg, num_points)``.
"""
from __future__ import annotations

import numpy as np

GROUND_Z = -1.8
N_GROUND = 60000
N_OBJ = 1500
OBJECTS = (8, 21)  # low, high exclusive
X_RANGE, Y_RANGE = (10, 70), (-6, 6)
FOCAL, CU, CV = 700.0, 600.0, 200.0
IMG_H, IMG_W = 400, 1200
NEAR_DEPTH = 40.0  # sample_points keeps every point beyond it


def object_counts(n_scans: int, rng: np.random.Generator) -> np.ndarray:
    """Objects per scan: the counts 8..20 in turn, in an order drawn from
    ``rng``, so that every seed's pool holds the same set of scene sizes."""
    counts = np.arange(n_scans) % (OBJECTS[1] - OBJECTS[0]) + OBJECTS[0]
    return rng.permutation(counts)


def make_scan(rng: np.random.Generator, n_objects: int):
    """One scan: (points (N, 4) float32 x, y, z, intensity; boxes (M, 7)
    float32 x, y, z, l, w, h, yaw in lidar coordinates)."""
    pts = [np.stack([rng.uniform(2, 80, N_GROUND), rng.uniform(-30, 30, N_GROUND),
                     np.full(N_GROUND, GROUND_Z) + rng.standard_normal(N_GROUND) * 0.02], 1)]
    boxes = []
    for _ in range(n_objects):
        l, w, h = rng.uniform(3.5, 4.5), rng.uniform(1.6, 2.0), rng.uniform(1.4, 1.7)
        cx, cy = rng.uniform(*X_RANGE), rng.uniform(*Y_RANGE)
        ry = rng.uniform(-np.pi, np.pi)
        box = np.array([cx, cy, GROUND_Z + h / 2, l, w, h, ry])
        local = rng.uniform(-0.5, 0.5, (N_OBJ, 3)) * [l, w, h]
        c, s = np.cos(ry), np.sin(ry)
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        pts.append(local @ rot.T + box[:3])
        boxes.append(box)
    cloud = np.concatenate(pts).astype(np.float32)
    scan = np.concatenate([cloud, rng.random((len(cloud), 1), dtype=np.float32)], 1)
    return scan, np.asarray(boxes, np.float32).reshape(-1, 7)


def fov_mask(points: np.ndarray) -> np.ndarray:
    """Points that project into the synthetic camera's image, in front of it."""
    x, y, z = points[:, 0].astype(np.float64), points[:, 1], points[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        u = (-FOCAL * y + CU * x) / x
        v = (-FOCAL * z + CV * x) / x
    return (u >= 0) & (u < IMG_W) & (v >= 0) & (v < IMG_H) & (x >= 0)


def range_mask(points: np.ndarray, pc_range) -> np.ndarray:
    return ((points[:, 0] >= pc_range[0]) & (points[:, 0] <= pc_range[3])
            & (points[:, 1] >= pc_range[1]) & (points[:, 1] <= pc_range[4]))


def sample_points(points: np.ndarray, num_points: int, rng: np.random.Generator):
    """``data/processor.py::sample_points``: every far point and a random
    draw of near ones, or the whole cloud topped up by a draw, shuffled."""
    if num_points < len(points):
        near = (points[:, 0:3] ** 2).sum(axis=1) < NEAR_DEPTH * NEAR_DEPTH
        far_idx, near_idx = np.where(~near)[0], np.where(near)[0]
        if num_points > len(far_idx):
            near_choice = rng.choice(near_idx, num_points - len(far_idx), replace=False)
            choice = np.concatenate((near_choice, far_idx)) if len(far_idx) else near_choice
        else:
            choice = rng.choice(np.arange(len(points), dtype=np.int32), num_points,
                                replace=False)
    else:
        choice = np.arange(len(points), dtype=np.int32)
        while num_points > len(choice):
            extra = rng.choice(len(points), min(len(points), num_points - len(choice)),
                               replace=False)
            choice = np.concatenate((choice, extra))
    rng.shuffle(choice)
    return points[choice]


def make_pool(seed: int, n_batches: int, batch: int, num_points: int, pc_range):
    """``n_batches`` batches of ``batch`` test-time scans of ``num_points``
    points: (points (n_batches, batch, num_points, 4) float32, gt_boxes
    (n_batches, batch, M, 8) float32 zero-padded, class 1 in the last column)."""
    rng = np.random.default_rng(seed)
    counts = object_counts(n_batches * batch, rng)
    scans, boxes = [], []
    for n_objects in counts:
        scan, box = make_scan(rng, int(n_objects))
        scan = scan[fov_mask(scan) & range_mask(scan, pc_range)]
        scans.append(sample_points(scan, num_points, rng))
        boxes.append(box)
    m = max(len(b) for b in boxes)
    gt = np.zeros((len(boxes), m, 8), np.float32)
    for i, box in enumerate(boxes):
        gt[i, :len(box), :7] = box
        gt[i, :len(box), 7] = 1.0
    points = np.stack(scans).reshape(n_batches, batch, num_points, 4)
    return points, gt.reshape(n_batches, batch, m, 8)


def make_batches(seed: int, mix: dict, cfg: dict, num_points: int):
    """An eval mix's pool: ``mix["pool"]`` batches of ``mix["batch"]`` scans
    of ``num_points`` points in ``cfg``'s point-cloud range (``make_pool``)."""
    return make_pool(seed, int(mix["pool"]), int(mix["batch"]), num_points,
                     cfg["DATA_CONFIG"]["POINT_CLOUD_RANGE"])
