"""Probe label-table gathers on the card.

    python -m modest_tpu_torch.tools.gather_probe [--n 131072] [--k 70] [--w 4096] [--iters 10] [--device cuda]

The port of ``scripts_dev/gather_probe.py``. A DBSCAN propagation round is
``min over masked labels[idx]`` with idx (N, K) banded (|idx − row| < W / 2
after x-sorting); the probes time ways to gather the labels, on the same
data from ``np.random.RandomState(0)``:

* A — ``labels[idx]``, then the masked min (PyTorch indexing);
* B — ``index_select``, then the masked min;
* A' — ``labels[idx]`` alone; compress — ``labels[labels]``;
* C — the banded one-hot product in bf16, chunk by chunk (plain PyTorch);
* D — ``ops.gather.take`` (``csrc/gather.cu``) on a (1024,) table with
  (256, K) indices and on the full (N,) table with (N, K);
* D2 — ``ops.gather.take_along_axis`` on (8, W) / (8, K) and (256, W) /
  (256, K) tiles of the labels;
* E — device-to-host and host-to-device copies of an (N, K) int16 table.

Prints one JSON line per probe. With ``--device cpu`` the probes check
their results and report no time (times come from the card only) and E is
not run.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..ops import gather
from ..utils.device import device_ms, resolve_device

N, K, W = 131072, 70, 4096
CHUNK = 1024  # rows per chunk of probe C


def probe_data(n: int = N, k: int = K, w: int = W, seed: int = 0):
    """The script's arrays: banded indices, a label permutation, a mask."""
    rng = np.random.RandomState(seed)
    off = rng.randint(-w // 2, w // 2, size=(n, k))
    idx = np.clip(np.arange(n)[:, None] + off, 0, n - 1).astype(np.int32)
    labels = rng.permutation(n).astype(np.int32)
    mask = rng.rand(n, k) < 0.5
    return idx, labels, mask


def _onehot_min(labels, idx_w, mask, los, n: int, w: int, chunk: int):
    """Probe C: each chunk of rows gathers from its W-wide label window by a
    (chunk, K, W) one-hot product in bf16 (exact here: one 1 per row)."""
    win_all = labels.to(torch.bfloat16)
    lane = torch.arange(w, device=labels.device)
    out = []
    for c, lo in enumerate(los.tolist()):
        ic = idx_w[c * chunk:(c + 1) * chunk].long() - lo
        oh = (ic[:, :, None] == lane).to(torch.bfloat16)
        g = torch.matmul(oh, win_all[lo:lo + w]).float()
        out.append(torch.where(mask[c * chunk:(c + 1) * chunk], g, float(n)).amin(1))
    return torch.cat(out).to(torch.int32)


def run(dev: torch.device, n: int = N, k: int = K, w: int = W, chunk: int = CHUNK,
        iters: int = 10):
    """All probes on ``dev``; returns their rows."""
    idx_h, labels_h, mask_h = probe_data(n, k, w)
    idx = torch.from_numpy(idx_h).to(dev)
    labels = torch.from_numpy(labels_h).to(dev)
    mask = torch.from_numpy(mask_h).to(dev)
    big = torch.tensor(n, dtype=torch.int32, device=dev)
    ref = torch.from_numpy(np.where(mask_h, labels_h[idx_h], n).min(axis=1)).to(dev)
    rows = []

    def row(probe, shape, fn, want=None, **extra):
        r = {"probe": probe, "shape": shape, "ms": device_ms(fn, dev, iters), **extra}
        if want is not None:
            r["correct"] = bool(torch.equal(fn(), want))
        rows.append(r)

    row("A", [n, k], lambda: torch.where(mask, labels[idx.long()], big).amin(1), want=ref)
    row("B", [n, k], lambda: torch.where(
        mask, torch.index_select(labels, 0, idx.reshape(-1)).reshape(n, k), big).amin(1),
        want=ref)
    row("A'", [n, k], lambda: labels[idx.long()])
    row("compress", [n], lambda: labels[labels.long()])

    los_h = np.clip(np.arange(0, n, chunk)[:, None] - w // 2, 0, n - w).reshape(-1)
    idx_w = torch.from_numpy(np.clip(idx_h, los_h.repeat(chunk)[:, None],
                                     (los_h + w - 1).repeat(chunk)[:, None]).astype(np.int32))
    idx_w = idx_w.to(dev)
    los = torch.from_numpy(los_h)
    # bf16 holds a label exactly only below 256: C is held to the same rounding
    labels_bf = torch.from_numpy(labels_h).to(torch.bfloat16).float()
    ref_c = torch.where(torch.from_numpy(mask_h), labels_bf[idx_w.cpu().long()],
                        float(n)).amin(1).to(torch.int32)
    row("C", [n, k, w], lambda: _onehot_min(labels, idx_w, mask, los, n, w, chunk),
        want=ref_c.to(dev), chunk=chunk)

    # D and D2: the kernels (the plain twins on the CPU)
    small_tab, small_idx = labels[:1024].contiguous(), (idx[:256] % 1024).contiguous()
    row("D_small", [1024, 256, k], lambda: gather.take(small_tab, small_idx),
        want=small_tab[small_idx.long()])
    errors = torch.zeros(1, dtype=torch.int32, device=dev)
    timed = (lambda: gather.take_cuda(labels, idx, errors)) if dev.type == "cuda" else None
    full = gather.take(labels, idx)
    rows.append({"probe": "D", "shape": [n, n, k], "ms": device_ms(timed, dev, iters),
                 "correct": bool(torch.equal(full, labels[idx.long()]))})
    for r in (8, 256):
        tab = labels[:w].repeat(r, 1).contiguous()
        sub = (idx[:r] % w).contiguous()
        out = gather.take_along_axis(tab, sub)
        timed = (lambda: gather.take_along_axis_cuda(tab, sub, errors)) \
            if dev.type == "cuda" else None
        rows.append({"probe": f"D2_{r}", "shape": [r, w, k], "ms": device_ms(timed, dev, iters),
                     "correct": bool(torch.equal(out, torch.gather(tab, 1, sub.long())))})
    if dev.type == "cuda":
        gather.raise_on_errors(errors, "gather_probe")

        # E: copies of an (N, K) int16 table
        mb = n * k * 2 / 1e6
        on_card = torch.zeros((n, k), dtype=torch.int16, device=dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        on_card.cpu()
        dt = time.perf_counter() - t0
        rows.append({"probe": "E_device_to_host", "shape": [n, k], "MB": mb, "ms": dt * 1e3,
                     "GB_per_s": mb / dt / 1e3})
        on_host = torch.zeros((n, k), dtype=torch.int16)
        t0 = time.perf_counter()
        on_host.to(dev)
        torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        rows.append({"probe": "E_host_to_device", "shape": [n, k], "MB": mb, "ms": dt * 1e3,
                     "GB_per_s": mb / dt / 1e3})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--k", type=int, default=K)
    ap.add_argument("--w", type=int, default=W)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    rows = run(dev, args.n, args.k, args.w, iters=args.iters)
    for r in rows:
        print(json.dumps({**r, "device": name}), flush=True)
    return 0 if all(r.get("correct", True) for r in rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
