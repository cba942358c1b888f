"""Rotated BEV IoU, 3D IoU and greedy rotated NMS — port of
``modest_tpu/ops/iou3d.py``.

The overlap of two rotated boxes is a Sutherland–Hodgman clip of the subject
quad against the clip quad's four half-planes, done on broadcast tensors:
polygon state is (..., 8) coordinate tensors (a quad ∩ quad has at most 8
vertices), and every operation runs over all pairs at once. The arithmetic
follows the JAX version step for step.

Box layout: (x, y, z, dx, dy, dz, heading), center z, heading CCW around +z.
"""
from __future__ import annotations

import torch

EPS = 1e-8
MAXV = 8  # max vertices of a quad ∩ quad intersection
NMS_BLOCK = 256  # candidates per NMS block
_LOCAL = ((-0.5, -0.5), (0.5, -0.5), (0.5, 0.5), (-0.5, 0.5))  # CCW


def _bev_corners(boxes):
    """(..., 7) → (x (..., 4), y (..., 4)) CCW BEV corners."""
    cx, cy, dx, dy, ang = (boxes[..., 0:1], boxes[..., 1:2], boxes[..., 3:4],
                           boxes[..., 4:5], boxes[..., 6:7])
    c, s = torch.cos(ang), torch.sin(ang)
    sx = torch.tensor([p[0] for p in _LOCAL], dtype=boxes.dtype, device=boxes.device)
    sy = torch.tensor([p[1] for p in _LOCAL], dtype=boxes.dtype, device=boxes.device)
    lx = sx * dx
    ly = sy * dy
    return lx * c - ly * s + cx, lx * s + ly * c + cy


def _overlap_sh(ax, ay, bx, by):
    """Intersection areas of subject quads (bx, by) clipped by quads (ax, ay).

    ax, ay: (..., 4) clip corners; bx, by: (..., 4) subject corners; the
    leading dims broadcast (e.g. (N, 1, 4) against (1, M, 4)). → (...)."""
    shape = torch.broadcast_shapes(ax.shape[:-1], bx.shape[:-1])
    dev, dt = bx.device, bx.dtype
    pad = torch.zeros(*shape, MAXV - 4, device=dev, dtype=dt)
    px = torch.cat([bx.expand(*shape, 4), pad], -1)
    py = torch.cat([by.expand(*shape, 4), pad], -1)
    valid = torch.zeros(*shape, MAXV, device=dev, dtype=torch.bool)
    valid[..., :4] = True
    slots = torch.arange(MAXV, device=dev)

    for e in range(4):
        a0x, a0y = ax[..., e:e + 1], ay[..., e:e + 1]
        a1x, a1y = ax[..., (e + 1) % 4:(e + 1) % 4 + 1], ay[..., (e + 1) % 4:(e + 1) % 4 + 1]
        ex, ey = a1x - a0x, a1y - a0y
        # ~1 mm distance tolerance: coincident-edge vertices stay inside
        tol = 1e-3 * torch.sqrt(ex * ex + ey * ey)

        d = ex * (py - a0y) - ey * (px - a0x)
        inside = d >= -tol
        # slot j's successor: slot j+1 if valid, else slot 0 (per lane)
        succ_ok = torch.cat([valid[..., 1:], torch.zeros_like(valid[..., :1])], -1)
        nx_ = torch.where(succ_ok, torch.roll(px, -1, -1), px[..., :1])
        ny_ = torch.where(succ_ok, torch.roll(py, -1, -1), py[..., :1])
        nd = ex * (ny_ - a0y) - ey * (nx_ - a0x)
        n_in = nd >= -tol
        denom = d - nd
        ok_den = denom.abs() > EPS
        t = d / torch.where(ok_den, denom, torch.ones_like(denom))
        ix = px + t * (nx_ - px)
        iy = py + t * (ny_ - py)
        # candidates interleaved per slot: [vertex j, crossing j], j = 0..7
        cand_x = torch.stack([px, ix], -1).flatten(-2)
        cand_y = torch.stack([py, iy], -1).flatten(-2)
        keep = torch.stack([inside & valid, (inside != n_in) & valid & ok_den], -1).flatten(-2)
        # compaction: the k-th kept candidate goes to slot k; candidates past
        # slot 7 (and dropped ones) land in a dump slot that is cut off
        rank = torch.cumsum(keep.to(torch.int32), -1) - 1
        dest = torch.where(keep & (rank < MAXV), rank, torch.full_like(rank, MAXV)).long()
        buf = torch.zeros(*shape, MAXV + 1, device=dev, dtype=dt)
        px = buf.scatter(-1, dest, cand_x)[..., :MAXV]
        py = buf.scatter(-1, dest, cand_y)[..., :MAXV]
        count = keep.sum(-1, keepdim=True).clamp_max(MAXV)
        valid = slots < count

    # shoelace over the compact polygon (per-lane wrap to slot 0)
    succ_ok = torch.cat([valid[..., 1:], torch.zeros_like(valid[..., :1])], -1)
    nx_ = torch.where(succ_ok, torch.roll(px, -1, -1), px[..., :1])
    ny_ = torch.where(succ_ok, torch.roll(py, -1, -1), py[..., :1])
    term = torch.where(valid, px * ny_ - nx_ * py, torch.zeros_like(px))
    area = term[..., 0]
    for j in range(1, MAXV):  # left-to-right, the JAX summation order
        area = area + term[..., j]
    count = valid.sum(-1)
    return torch.where(count >= 3, 0.5 * area.abs(), torch.zeros_like(area))


def boxes_overlap_bev(boxes_a, boxes_b):
    """(..., N, 7), (..., M, 7) → (..., N, M) BEV intersection areas; the
    box of row n clips the box of column m."""
    ax, ay = _bev_corners(boxes_a[..., :, None, :])
    bx, by = _bev_corners(boxes_b[..., None, :, :])
    return _overlap_sh(ax, ay, bx, by)


def boxes_iou_bev(boxes_a, boxes_b):
    """(..., N, 7), (..., M, 7) → (..., N, M) rotated BEV IoU."""
    overlap = boxes_overlap_bev(boxes_a, boxes_b)
    sa = (boxes_a[..., 3] * boxes_a[..., 4])[..., :, None]
    sb = (boxes_b[..., 3] * boxes_b[..., 4])[..., None, :]
    return overlap / torch.clamp_min(sa + sb - overlap, EPS)


def boxes_iou3d(boxes_a, boxes_b):
    """(..., N, 7), (..., M, 7) → (..., N, M) 3D IoU."""
    overlap_bev = boxes_overlap_bev(boxes_a, boxes_b)
    a_max = (boxes_a[..., 2] + boxes_a[..., 5] / 2)[..., :, None]
    a_min = (boxes_a[..., 2] - boxes_a[..., 5] / 2)[..., :, None]
    b_max = (boxes_b[..., 2] + boxes_b[..., 5] / 2)[..., None, :]
    b_min = (boxes_b[..., 2] - boxes_b[..., 5] / 2)[..., None, :]
    overlap_h = torch.clamp_min(torch.minimum(a_max, b_max) - torch.maximum(a_min, b_min), 0)
    overlap_3d = overlap_bev * overlap_h
    vol_a = (boxes_a[..., 3] * boxes_a[..., 4] * boxes_a[..., 5])[..., :, None]
    vol_b = (boxes_b[..., 3] * boxes_b[..., 4] * boxes_b[..., 5])[..., None, :]
    return overlap_3d / torch.clamp_min(vol_a + vol_b - overlap_3d, 1e-6)


def nms_bev(boxes, scores, thresh: float, max_keep: int):
    """Greedy rotated-BEV NMS, batched over scenes.

    boxes (B, N, 7); scores (B, N), with -inf on rows that must not be kept.
    Returns keep_idx (B, max_keep) int64 and keep_mask (B, max_keep) bool:
    the kept boxes in greedy order (score descending, ties to the lower
    index), 0 in the unused slots — the keep set of JAX's greedy scan.

    Candidates go in score order in blocks of ``NMS_BLOCK``. Per block, one
    (kept × block) IoU matrix finds what earlier keeps suppress, and one
    (block × block) matrix, with the earlier candidate as the clip box as in
    the greedy scan, holds the in-block suppressions. The in-block greedy
    recurrence (keep t unless a kept s < t suppresses it) has one solution,
    and a Jacobi iteration reaches it; it usually settles in a few rounds.
    The loop stops once every scene has ``max_keep`` boxes or runs out of
    candidates: a greedy keep depends only on higher-scored boxes.
    """
    b, n, _ = boxes.shape
    dev = boxes.device
    neg_inf = float("-inf")
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    sboxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 7))
    sscores = torch.gather(scores, 1, order)

    kept_boxes = torch.zeros(b, max_keep, 7, device=dev, dtype=boxes.dtype)
    kcnt = torch.zeros(b, dtype=torch.long, device=dev)
    keep_flags = torch.zeros(b, n, dtype=torch.bool, device=dev)
    krow = torch.arange(max_keep, device=dev)
    for f0 in range(0, n, NMS_BLOCK):
        open_ = (kcnt < max_keep) & (sscores[:, f0] > neg_inf)
        if not bool(open_.any()):
            break
        cand = sboxes[:, f0:f0 + NMS_BLOCK]
        t = cand.shape[1]
        valid = (sscores[:, f0:f0 + t] > neg_inf) & open_[:, None]
        sup = ((boxes_iou_bev(kept_boxes, cand) > thresh)
               & (krow[None, :, None] < kcnt[:, None, None])).any(1)
        earlier = torch.ones(t, t, dtype=torch.bool, device=dev).triu(1)
        s_in = (boxes_iou_bev(cand, cand) > thresh) & earlier  # [s, t]: s < t suppresses t
        base = valid & ~sup
        keep = base
        while True:
            new = base & ~(s_in & keep[:, :, None]).any(1)
            if torch.equal(new, keep):
                break
            keep = new
        keep = keep & (torch.cumsum(keep.long(), -1) <= (max_keep - kcnt)[:, None])
        pos = kcnt[:, None] + torch.cumsum(keep.long(), -1) - 1
        pos = torch.where(keep, pos, torch.full_like(pos, max_keep))
        buf = torch.cat([kept_boxes, torch.zeros(b, 1, 7, device=dev, dtype=boxes.dtype)], 1)
        kept_boxes = buf.scatter(1, pos[..., None].expand(-1, -1, 7), cand)[:, :max_keep]
        keep_flags[:, f0:f0 + t] = keep
        kcnt = kcnt + keep.sum(-1)

    # the first max_keep kept sorted positions, in score order
    rank = torch.cumsum(keep_flags.long(), -1) - 1
    slot = torch.where(keep_flags, rank, torch.full_like(rank, max_keep))
    pos = torch.arange(n, device=dev).expand(b, n)
    out_pos = torch.zeros(b, max_keep + 1, dtype=torch.long, device=dev).scatter(1, slot, pos)
    keep_mask = krow[None, :] < kcnt[:, None]
    keep_idx = torch.where(keep_mask, torch.gather(order, 1, out_pos[:, :max_keep]),
                           torch.zeros_like(out_pos[:, :max_keep]))
    return keep_idx, keep_mask


def class_agnostic_nms(box_scores, box_preds, nms_thresh: float, score_thresh=None,
                       pre_maxsize=None, post_maxsize: int = 512):
    """Score-thresholded rotated NMS (reference model_nms_utils.py:6-34),
    batched: box_scores (B, N), box_preds (B, N, 7). Scores that are not
    finite or not above ``score_thresh`` are never kept; with ``pre_maxsize``
    below N only the best ``pre_maxsize`` (ties to the lower index, as
    ``lax.top_k``) enter the NMS. Returns (B, post_maxsize) indices into N
    and their validity."""
    valid = torch.isfinite(box_scores)
    if score_thresh is not None:
        valid &= box_scores > score_thresh
    scores = torch.where(valid, box_scores, float("-inf"))
    if pre_maxsize is None or pre_maxsize >= scores.shape[1]:
        return nms_bev(box_preds, scores, nms_thresh, post_maxsize)
    top_idx = torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :pre_maxsize]
    keep, keep_mask = nms_bev(torch.gather(box_preds, 1, top_idx[..., None].expand(-1, -1, 7)),
                              torch.gather(scores, 1, top_idx), nms_thresh, post_maxsize)
    return torch.gather(top_idx, 1, keep), keep_mask


def multi_classes_nms(cls_scores, box_preds, nms_thresh: float, score_thresh=None,
                      pre_maxsize=None, post_maxsize: int = 512):
    """Per-class rotated NMS (reference model_nms_utils.multi_classes_nms),
    batched: cls_scores (B, N, C), box_preds (B, N, 7) shared by the classes
    or (B, N, C, 7) per class. Each class keeps ``post_maxsize`` slots,
    concatenated in class order. Returns (scores, labels (1-based), indices
    into N, validity), each (B, C·post_maxsize); an unused slot scores 0.
    The classes run as one batch of B·C NMS problems."""
    b, n, c = cls_scores.shape
    if box_preds.dim() == 3:
        box_preds = box_preds[:, :, None].expand(-1, -1, c, -1)
    boxes = box_preds[..., :7].permute(0, 2, 1, 3).reshape(b * c, n, 7)
    scores = cls_scores.permute(0, 2, 1).reshape(b * c, n)
    idx, mask = class_agnostic_nms(scores, boxes, nms_thresh, score_thresh, pre_maxsize,
                                   post_maxsize)
    kept = torch.where(mask, torch.gather(scores, 1, idx), 0.0)
    labels = torch.arange(1, c + 1, device=idx.device).repeat_interleave(post_maxsize)
    return (kept.reshape(b, c * post_maxsize), labels.expand(b, -1),
            idx.reshape(b, c * post_maxsize), mask.reshape(b, c * post_maxsize))
