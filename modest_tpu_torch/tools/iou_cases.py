"""Inputs that hold the rotated-IoU kernel (``csrc/iou3d.cu``) to its plain
twin: adversarial box sets and proposal-like batches at the NMS shapes of
the benchmark's cells. ``tests/test_torch_iou3d_kernel.py`` and
``chip_smoke.py``'s phase ``iou_kernel_vs_plain`` share them.

Every set is made with numpy from a fixed seed, in float64; a caller casts
it to the dtype it checks.
"""
from __future__ import annotations

import math

import numpy as np

# (name, B, kept rows, block): boxes_iou_bev(kept_boxes, block) inside
# ops/iou3d.py::_nms_bev at the cells' loads: PointRCNN's eval proposal NMS
# (9000 -> 100), the post NMS's kept rows (500), a block against itself,
# and the train-mode proposal NMS (9000 -> 512)
NMS_SHAPES = (("eval_proposal", 4, 100, 256), ("post", 4, 500, 256),
              ("block", 4, 256, 256), ("train_proposal", 2, 512, 256))

# (name, B, candidates, valid candidates, max_keep, IoU threshold): nms_bev
# as each cell's NMS stage calls it (pointrcnn_dynamic_obj.yaml and
# second_dynamic_obj.yaml; SECOND's 1024 candidates a scan are the
# benchmark's assumed load)
NMS_CELLS = (("pointrcnn.eval.b4.proposal", 4, 9000, 9000, 100, 0.85),
             ("pointrcnn.eval.b4.post", 4, 100, 100, 100, 0.1),
             ("second.eval.b4.post", 4, 4096, 1024, 500, 0.01),
             ("pointrcnn.train.b2.proposal", 2, 9000, 9000, 512, 0.8))

_TOL = 1e-3  # the clip's distance tolerance, 1 mm


def adversarial_boxes():
    """(names, (K, 7) float64): boxes whose pairs meet the clip's edge cases.

    Identical boxes, 90° and 180° turns of one footprint, shared edges,
    coincident corners, a square against its 45° turn (the octagon: eight
    kept candidates at the last edge, the most any box pair was seen to
    keep), an all-zero row (the unused rows of the NMS's ``kept_boxes``),
    1 cm and 50 m boxes, boxes far apart (one 1.4 km out), and one box
    inside another."""
    rows = []

    def add(name, x, y, dx, dy, heading, z=0.0, dz=1.5):
        rows.append((name, [x, y, z, dx, dy, dz, heading]))

    h = 0.3
    c, s = math.cos(h), math.sin(h)
    add("base", 0.0, 0.0, 4.0, 2.0, h)
    add("identical", 0.0, 0.0, 4.0, 2.0, h)
    add("turn_90", 0.0, 0.0, 2.0, 4.0, h + math.pi / 2)
    add("turn_180", 0.0, 0.0, 4.0, 2.0, h + math.pi)
    add("turn_minus_90", 0.0, 0.0, 2.0, 4.0, h - math.pi / 2)
    add("shared_edge_long", 4.0 * c, 4.0 * s, 4.0, 2.0, h)
    add("shared_edge_short", -2.0 * s, 2.0 * c, 4.0, 2.0, h)
    add("axis", 0.0, 0.0, 4.0, 2.0, 0.0)
    add("axis_shared_edge", 4.0, 0.0, 4.0, 2.0, 0.0)
    add("axis_corner", 4.0, 2.0, 4.0, 2.0, 0.0)
    r = math.sqrt(2.0)  # a 2 x 2 square turned 45° with a corner on (2, 1)
    add("corner_on_corner_45", 2.0 + r, 1.0, 2.0, 2.0, math.pi / 4)
    add("square", 0.0, 0.0, 2.0, 2.0, 0.0)
    add("square_45", 0.0, 0.0, 2.0, 2.0, math.pi / 4)
    add("zero_row", 0.0, 0.0, 0.0, 0.0, 0.0, dz=0.0)
    add("cm", 0.001, 0.002, 0.01, 0.01, 0.7)
    add("cm_turned", 0.0, 0.0, 0.01, 0.012, 1.3)
    add("m50", 10.0, -5.0, 50.0, 50.0, 0.2)
    add("m50_turned", 30.0, 20.0, 50.0, 40.0, -1.0)
    add("far_apart", -60.0, 70.0, 4.0, 2.0, 1.1)
    add("far_out", 1000.0, -1000.0, 4.0, 2.0, h)
    add("inside", 0.2, 0.1, 1.0, 0.5, 1.0)
    add("contains", 0.0, 0.0, 10.0, 10.0, 0.1)
    names = [name for name, _ in rows]
    return names, np.array([box for _, box in rows], np.float64)


def tolerance_boxes():
    """(names, (K, 7) float64): copies of ``adversarial_boxes``' base box
    shifted, grown and turned by half, one and two times the clip's 1 mm
    tolerance, so that corners sit inside, on and beyond its band. There the
    clip is ill-conditioned: which side of the band a corner falls on is
    decided by rounding, and a crossing's denominator can be rounding noise
    above the 1e-8 guard, so two correct roundings of one formula part (in
    float32, the base box shifted by 1 mm overlaps its copy by 44.08 m² in
    the port's clip, 7.998 in JAX's). The kernel is held to its plain twin
    here bit for bit; the JAX package is not."""
    h = 0.3
    c, s = math.cos(h), math.sin(h)
    rows = [("base", [0.0, 0.0, 0.0, 4.0, 2.0, 1.5, h]),
            ("turn_180", [0.0, 0.0, 0.0, 4.0, 2.0, 1.5, h + math.pi])]
    for k, eps in enumerate((0.5 * _TOL, _TOL, 2.0 * _TOL)):
        rows.append((f"shift_{k}", [eps * c, eps * s, 0.0, 4.0, 2.0, 1.5, h]))
        rows.append((f"grow_{k}", [0.0, 0.0, 0.0, 4.0 + 2.0 * eps, 2.0 - 2.0 * eps, 1.5, h]))
        rows.append((f"twist_{k}", [0.0, 0.0, 0.0, 4.0, 2.0, 1.5, h + eps / 2.0]))
    names = [name for name, _ in rows]
    return names, np.array([box for _, box in rows], np.float64)


def near_coincident_boxes():
    """(64, 7) float64: millimetre-scale boxes around one point, so that the
    1 mm tolerance band decides most vertices; their pairs keep up to eight
    candidates at a clip edge."""
    rng, n = np.random.RandomState(0), 64
    out = np.zeros((n, 7))
    out[:, 0:2] = rng.uniform(-1.0, 1.0, (n, 2)) * 0.005
    out[:, 3:5] = rng.uniform(0.3, 1.5, (n, 2)) * 0.01
    out[:, 5] = 1.0
    out[:, 6] = rng.uniform(-math.pi, math.pi, n)
    return out


def scene_boxes(rng, shape, spread: float = 40.0):
    """``shape`` + (7,) float64 proposal-like boxes: car-sized boxes jittered
    around 24 objects of a scene ``spread`` metres across, so that
    neighbours overlap as an NMS's candidates do."""
    centres = rng.uniform(-spread, spread, (24, 2))
    pick = rng.randint(0, 24, shape)
    out = np.zeros((*shape, 7))
    out[..., 0:2] = centres[pick] + rng.normal(0.0, 0.4, (*shape, 2))
    out[..., 2] = rng.uniform(-1.0, 1.0, shape)
    out[..., 3] = rng.uniform(3.5, 4.8, shape)
    out[..., 4] = rng.uniform(1.6, 2.1, shape)
    out[..., 5] = rng.uniform(1.4, 1.8, shape)
    out[..., 6] = rng.uniform(-math.pi, math.pi, shape)
    return out


def nms_operands(batch: int, kept: int, block: int):
    """(kept_boxes (B, kept, 7), block (B, block, 7)) float64 as ``_nms_bev``
    meets them: the kept rows' last quarter left at zero, as the unused rows
    of ``kept_boxes`` are."""
    rng = np.random.RandomState(0)
    kept_boxes = scene_boxes(rng, (batch, kept))
    kept_boxes[:, kept - kept // 4:] = 0.0
    return kept_boxes, scene_boxes(rng, (batch, block))


def nms_inputs(batch: int, n: int, valid: int):
    """(boxes (B, n, 7) float64, scores (B, n) float64) for ``nms_bev``:
    scores in (0, 1), ``-inf`` past the first ``valid`` candidates."""
    rng = np.random.RandomState(11)
    boxes = scene_boxes(rng, (batch, n))
    scores = rng.uniform(0.0, 1.0, (batch, n))
    scores[:, valid:] = -np.inf
    return boxes, scores
