"""The windowed kNN against the dense path at the flagship backbone's kNN shapes.

    python -m modest_tpu_torch.tools.knn_bench [--batch 4] [--iters 20] [--device cuda]

The port of ``scripts_dev/pallas_knn_bench.py``: the same four shapes (SA1
and SA2 grouping in radius mode, FP0 and FP1 interpolation in three-NN
mode) on the same Lyft-like clouds from ``np.random.RandomState(0)``. For
each shape it prints one JSON line: the coverage certificate, the slot match
of the windowed result against the dense exact path (d² within rtol 3e-3,
atol 1e-5 on every slot inside the criterion, d² < r² or all k in three-NN
mode, as the JAX script counts it), the same against the dense expansion
path, the dense fallbacks of ``nearest_k``, and the windowed and dense
times on the card. The dense exact path is the direct-difference d² and an
exact top-k; the dense path that is timed is ``nearest_topk(pairwise_dist2)``,
whose |a|² + |b|² − 2ab expansion loses ~1e-3 m² to cancellation at 25–100
m, so its own slot match falls short of the criterion. With ``--device cpu``
the checks run and no time is reported: times come from the card only.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops import knn
from ..ops.pointnet2 import nearest_topk, pairwise_dist2
from ..utils.device import device_ms, resolve_device

SHAPES = [  # (tag, M, N, k, radius)
    ("SA1 4096<-12288 k=32 r=0.5", 4096, 12288, 32, 0.5),
    ("SA2 1024<-4096  k=32 r=1.0", 1024, 4096, 32, 1.0),
    ("FP0 12288<-4096 k=3 (3nn)", 12288, 4096, 3, None),
    ("FP1 4096<-1024  k=3 (3nn)", 4096, 1024, 3, None),
]
RTOL, ATOL = 3e-3, 1e-5
_DENSE_ROWS = 1024  # query rows per step of the dense exact path


def make_cloud(rng, b: int, n: int) -> np.ndarray:
    """Lyft-like non-uniform density: heavier near-field."""
    x = np.abs(rng.standard_normal((b, n)) * 25) + 1
    y = rng.standard_normal((b, n)) * 18
    z = rng.uniform(-2, 1, (b, n))
    return np.stack([x, y, z], -1).astype(np.float32)


def shape_cases(b: int, seed: int = 0):
    """The four shapes' clouds, drawn in the JAX script's order: queries are
    sampled from the candidates when M <= N, else a cloud of their own."""
    rng = np.random.RandomState(seed)
    cases = []
    for tag, m, n, k, radius in SHAPES:
        xyz = make_cloud(rng, b, n)
        if m <= n:
            new_xyz = np.take_along_axis(
                xyz, rng.choice(n, (b, m, 1), replace=True).astype(np.int64), 1)
        else:
            new_xyz = make_cloud(rng, b, m)
        cases.append({"tag": tag, "m": m, "n": n, "k": k, "radius": radius,
                      "xyz": xyz, "new_xyz": new_xyz})
    return cases


def dense_exact(new_xyz, xyz, k: int):
    """The exact k nearest: direct-difference d² ((dx² + dy²) + dz²) and an
    exact top-k with ties to the lower index."""
    d2s, idxs = [], []
    for a in range(0, new_xyz.shape[1], _DENSE_ROWS):
        d = new_xyz[:, a:a + _DENSE_ROWS, None, :] - xyz[:, None, :, :]
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
        del d
        top_d2, top_idx = nearest_topk(d2, k)
        d2s.append(top_d2)
        idxs.append(top_idx)
    return torch.cat(d2s, 1), torch.cat(idxs, 1)


def dense_path(new_xyz, xyz, k: int):
    """The dense path ``nearest_k`` falls back to: the expansion d² and an
    exact top-k."""
    return nearest_topk(pairwise_dist2(new_xyz, xyz), k)


def slot_match(td2, ed2, radius) -> float:
    """Share of the (B, M, k) slots whose d² agree, counting a slot outside
    the criterion (reference d² ≥ r²) as agreeing, as the JAX script does."""
    r2 = radius * radius if radius is not None else float("inf")
    inside = ed2 < min(r2, 1e30)
    zero = torch.zeros((), dtype=td2.dtype, device=td2.device)
    ok = torch.isclose(torch.where(inside, td2, zero), torch.where(inside, ed2, zero),
                       rtol=RTOL, atol=ATOL)
    return float(ok.double().mean())


def run_case(case, dev: torch.device, iters: int) -> dict:
    """One shape: ``nearest_k`` with the dense fallback, the certificate and
    slot matches of the windowed result, then the windowed and dense times."""
    new_xyz = torch.from_numpy(case["new_xyz"]).to(dev)
    xyz = torch.from_numpy(case["xyz"]).to(dev)
    k, radius = case["k"], case["radius"]
    w = knn._pick_window(case["n"])
    fallbacks = knn.nearest_k.dense_fallbacks
    knn.nearest_k(new_xyz, xyz, k, radius, dense_fn=dense_path)
    fallbacks = knn.nearest_k.dense_fallbacks - fallbacks

    td2, _, ok = knn._prep_and_run(new_xyz, xyz, k, w, radius)
    ed2, _ = dense_exact(new_xyz, xyz, k)
    xd2, _ = dense_path(new_xyz, xyz, k)
    r2 = radius * radius if radius is not None else float("inf")
    row = {"tag": case["tag"], "B": xyz.shape[0], "M": case["m"], "N": case["n"], "k": k,
           "radius": radius, "window": w, "certificate": bool(ok),
           "slot_match_pct": 100 * slot_match(td2, ed2, radius),
           "slot_match_vs_expansion_pct": 100 * slot_match(td2, xd2, radius),
           "in_criterion_slots": int((ed2 < min(r2, 1e30)).sum()),
           "dense_fallbacks": fallbacks}
    del td2, ed2, xd2
    row["windowed_ms"] = device_ms(lambda: knn._prep_and_run(new_xyz, xyz, k, w, radius),
                                   dev, iters)
    row["dense_ms"] = device_ms(lambda: dense_path(new_xyz, xyz, k), dev, iters)
    return row


def run(dev: torch.device, batch: int = 4, iters: int = 20, seed: int = 0):
    return [run_case(case, dev, iters) for case in shape_cases(batch, seed)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    for row in run(dev, args.batch, args.iters):
        print(json.dumps({**row, "device": name}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
