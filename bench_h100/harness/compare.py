"""The numbers that decide ``correct``: the port's outputs against the plain
reference's on the same inputs and weights.

``match_1to1`` is a frozen copy of ``chip_smoke.py``'s greedy 1:1 box match
(centre within 1 cm, sizes within 2e-3 m, score within 5e-4); a pair also
needs its yaw within 2e-3 rad and the same label (``chip_smoke.py::
match_finals``). Each number is 0 where the two sides agree and grows with
the disagreement.
"""
from __future__ import annotations

import numpy as np
import torch

MATCH_CENTER, MATCH_SIZE, MATCH_SCORE = 1e-2, 2e-3, 5e-4


def match_1to1(boxes, scores, rb, rs):
    used = np.zeros(len(boxes), bool)
    pairs = []
    for j in range(len(rb)):
        d = np.linalg.norm(boxes[:, :3] - rb[j, :3], axis=1)
        ds = np.abs(boxes[:, 3:6] - rb[j, 3:6]).max(axis=1)
        cand = np.flatnonzero((d < MATCH_CENTER) & (ds < MATCH_SIZE)
                              & (np.abs(scores - rs[j]) < MATCH_SCORE) & ~used)
        if len(cand):
            used[cand[0]] = True
            pairs.append((int(cand[0]), j))
    return pairs


def _yaw_gap(a, b):
    d = abs(float(a) - float(b)) % (2 * np.pi)
    return min(d, 2 * np.pi - d)


def box_miss(got, want, labels: bool = True):
    """(boxes on either side without a partner, boxes on the larger side),
    summed over the scans of one batch; ``got`` and ``want`` map "valid",
    "boxes", "scores" and, with ``labels``, "labels" to (B, K, ...) tensors
    or arrays."""
    def host(x):
        return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)

    miss = total = 0
    for i in range(host(got["valid"]).shape[0]):
        gv, wv = host(got["valid"])[i].astype(bool), host(want["valid"])[i].astype(bool)
        gb, wb = host(got["boxes"])[i][gv], host(want["boxes"])[i][wv]
        gs, ws = host(got["scores"])[i][gv], host(want["scores"])[i][wv]
        gl = host(got["labels"])[i][gv] if labels else np.zeros(len(gb))
        wl = host(want["labels"])[i][wv] if labels else np.zeros(len(wb))
        pairs = match_1to1(gb, gs, wb, ws)
        good = sum(1 for a, j in pairs
                   if _yaw_gap(gb[a, 6], wb[j, 6]) < MATCH_SIZE and gl[a] == wl[j])
        n = max(len(gb), len(wb))
        miss += n - good
        total += n
    return miss, total


def widest_gap(got, want) -> float:
    """The largest |got − want| of two same-shaped tensors."""
    return float((got.float() - want.float()).abs().max())


class Tally:
    """Accumulates one cell's numbers over the compared batches: the widest
    gaps by maximum, the miss shares as (missed, total) sums."""

    def __init__(self):
        self.gaps: dict[str, float] = {}
        self.misses: dict[str, list[int]] = {}

    def gap(self, name: str, value: float) -> None:
        self.gaps[name] = max(self.gaps.get(name, 0.0), value)

    def miss(self, name: str, missed: int, total: int) -> None:
        acc = self.misses.setdefault(name, [0, 0])
        acc[0] += missed
        acc[1] += total

    def numbers(self) -> dict[str, float]:
        out = dict(self.gaps)
        for name, (missed, total) in self.misses.items():
            out[name] = missed / total if total else 1.0
        return out
