"""Synthetic kNN graphs with one-way tie edges, for DBSCAN's propagation.

``tie_chain_graph`` builds (idx, d2, pp, valid) for B frames of N points
whose rows are an exact top-k (ties to the lower index) under a symmetric
distance, as the seed path's kNN rows are, shaped so that the directed
min-reachable labels of ``pipeline/clustering.py::_cluster_from_knn_impl``
differ from the minima of the undirected components.

Each frame holds blocks of k + 1 points (the points left over are invalid).
In a block the points sit at u = 0..k on a line, d²(u, v) = (s·|u − v|)²
with s = 1.9 / k (every block pair lies within a 2 m radius), and each row
lists its k block mates. Blocks are strung into chains A_0 → A_1 → …: the
point a at u = 0 of A_t (its block's highest index) lists b, the point at
u_b = k // 2 − 1 of A_{t+1}, in place of its farthest mate, at b's k-th
distance d²(k − u_b). b's row keeps its k mates: its mate at u = k (its
block's lowest index) lies at that distance too and wins the tie against a.
So a → b is a one-way tie edge, every block is a two-way component, and a
block's directed label is the smallest index over its chain from there on.

    python -m modest_tpu_torch.tools.tie_graph   # counts for one full-size group
"""
from __future__ import annotations

import numpy as np

SCALE = 1.9  # block span in metres: d² ≤ 3.61 < the seed path's r² = 4


def tie_chain_graph(frames: int, n: int, k: int, seed: int, max_chain: int = 12):
    """(idx (B, N, k) int32, d2 (B, N, k) float32, pp (B, N) float32 zeros,
    valid (B, N) bool) as described above; k ≥ 4."""
    if k < 4 or n < k + 1:
        raise ValueError(f"tie_chain_graph needs k >= 4 and n >= k + 1, got n={n} k={k}")
    rng = np.random.RandomState(seed)
    m = k + 1
    nb = n // m
    dtab = ((SCALE / k * np.arange(m, dtype=np.float64)) ** 2).astype(np.float32)
    u = np.arange(m)
    cand_v = np.stack([np.delete(u, i) for i in u])           # (m, k) mates of each u
    ub = k // 2 - 1
    idx = np.zeros((frames, n, k), np.int32)
    d2 = np.full((frames, n, k), np.inf, np.float32)
    valid = np.zeros((frames, n), bool)
    for f in range(frames):
        pts = np.sort(rng.permutation(n)[:nb * m].reshape(nb, m), axis=1)
        mid = np.take_along_axis(pts[:, 1:-1], np.argsort(rng.rand(nb, m - 2), axis=1), axis=1)
        ids = np.concatenate([pts[:, -1:], mid, pts[:, :1]], axis=1)  # ids[block, u]
        cand_id = ids[:, cand_v]                                       # (nb, m, k)
        cand_d = np.broadcast_to(np.abs(u[:, None] - cand_v), (nb, m, k)).copy()
        # chains over a random block order; a bridge needs a's index above
        # the index of b's mate at u = k, so that the mate wins the tie
        order = rng.permutation(nb)
        cuts = np.cumsum(rng.randint(1, max_chain + 1, size=nb))
        starts = set(np.concatenate([[0], cuts[cuts < nb]]).tolist())
        for t in range(nb - 1):
            if t + 1 in starts:
                continue
            src, dst = order[t], order[t + 1]
            if ids[src, 0] > ids[dst, k]:
                cand_id[src, 0, -1] = ids[dst, ub]  # replaces the farthest mate, u = k
                cand_d[src, 0, -1] = k - ub
        srt = np.argsort(cand_d.astype(np.int64) * n + cand_id, axis=2)
        rows = ids.reshape(-1)
        idx[f, rows] = np.take_along_axis(cand_id, srt, axis=2).reshape(-1, k)
        d2[f, rows] = dtab[np.take_along_axis(cand_d, srt, axis=2)].reshape(-1, k)
        valid[f, rows] = True
    return idx, d2, np.zeros((frames, n), np.float32), valid


if __name__ == "__main__":
    i, d, _, v = tie_chain_graph(4, 49152, 70, seed=0)
    print({"frames": 4, "N": 49152, "k": 70, "valid": int(v.sum()),
           "finite_slots": int(np.isfinite(d).sum())})
