"""Where the time of the port's eval forward goes on the card.

    python -m modest_tpu_torch.tools.profile_eval [--batch 4] [--out build/profile]

Runs the flagship PointRCNN eval forward + post_process (12288-point scans,
the bench.py scene recipe, seeded random weights) under ``torch.profiler``
after two warm-up passes, and prints one JSON line: wall time per forward,
summed kernel time, the device's busy share, kernel launches, and the
kernels and kernel groups that take the most device time. A second profiled
pass runs with the port's tracer (``utils/trace.py``) on: its Chrome trace,
written beside the line, holds the ``modest:`` spans (``nms``,
``iou.overlap``, ``nms.host_read``), and the line gains each span's count
and host time and the tracer's counters under ``traced``. The first pass's
numbers are read with the tracer off, so its ranges cost them nothing.
Last, ``loader`` reads the training loader's spans and counters over two
epochs (after one that starts its workers) of ``LOADER_SCANS`` synthetic
scans of the flagship's dataset at ``--batch``, with ``LOADER_WORKERS``
worker processes: the time under ``loader.epoch_start`` (an epoch's restart),
``loader.wait`` and ``loader.to_device``, and how many of the workers'
batches were already done at a request, on average. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from ..configs import (POINTRCNN_DYNAMIC_OBJ, POINTRCNN_DYNAMIC_OBJ_CLASS_NAMES,
                       POINTRCNN_DYNAMIC_OBJ_DATA_CONFIG, POINTRCNN_DYNAMIC_OBJ_NUM_POINTS)
from ..models import api, build_network
from ..utils import trace as port_trace
from ..utils.config import Config
from .scenes import bench_scans

LOADER_SCANS = 16  # chip_smoke.py's training set
LOADER_WORKERS = 4  # cli/train.py's default, and the benchmark's train cells'

# kernel-name pattern → group, first match wins
GROUPS = (
    ("fps (hand kernel)", r"fps_(cluster|warp)_kernel"),
    ("matmul", r"gemm|sgemm|cutlass|ampere|sm90|xmma"),
    ("sort / top-k", r"sort|topk|radix|Sort|TopK|bitonic|gatherTopK"),
    ("gather / scatter / index", r"gather|scatter|index|Index"),
    ("reduce", r"reduce|Reduce"),
    ("elementwise", r"elementwise|vectorized|unrolled|Elementwise"),
)


def _device_us(evt) -> float:
    total = getattr(evt, "self_device_time_total", None)
    return float(total if total is not None else evt.self_cuda_time_total)


def span_table(prof) -> dict:
    """The tracer's spans in a profile: for each ``modest:`` range, how many
    opened and their host time in ms, the ranges inside included."""
    return {e.key[len(port_trace.PREFIX):]: {"count": e.count, "host_ms": e.cpu_time_total / 1e3}
            for e in prof.key_averages()
            if e.key.startswith(port_trace.PREFIX) and e.device_type.name == "CPU"}


def profile_loader(root, batch: int, workers: int, device, scans: int = LOADER_SCANS,
                   full_density: bool = True) -> dict:
    """The training loader's spans and counters over two epochs, after one
    that starts its workers: ``scans`` synthetic scans of the flagship's
    dataset (``tools/synth_kitti.py``) written under ``root``, batches of
    ``batch`` copied to ``device`` by ``prefetch_to_device``."""
    from ..data.kitti_dataset import create_kitti_infos
    from ..data.loader import build_dataloader, prefetch_to_device
    from .synth_kitti import make_dataset

    data_cfg = Config(POINTRCNN_DYNAMIC_OBJ_DATA_CONFIG)
    data_cfg.DATA_PATH = str(root)
    names = list(POINTRCNN_DYNAMIC_OBJ_CLASS_NAMES)
    with contextlib.redirect_stdout(sys.stderr):  # stdout holds the one JSON line
        make_dataset(root, n_train=scans, n_val=0, seed=0, full_density=full_density)
        create_kitti_infos(data_cfg, names, root, root, if_val=False)
        _, loader = build_dataloader(data_cfg, names, batch, training=True, num_workers=workers)
    try:
        for _ in prefetch_to_device(loader, device):
            pass
        port_trace.enable()
        try:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                for epoch in (1, 2):
                    loader.set_epoch(epoch)
                    for _ in prefetch_to_device(loader, device):
                        pass
        finally:
            counts = port_trace.disable()
    finally:
        loader.close()
    asks = counts.get("loader.asks", 0)
    return {"scans": scans, "batch": batch, "workers": workers, "epochs": 2,
            "spans": span_table(prof), "counters": counts,
            "ready_per_ask": counts.get("loader.ready", 0) / asks if asks else None}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--out", default="build/profile", help="directory for the Chrome trace")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_eval needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config(POINTRCNN_DYNAMIC_OBJ)
    model = build_network(cfg, len(POINTRCNN_DYNAMIC_OBJ_CLASS_NAMES), device="cuda", seed=0)
    points = torch.from_numpy(bench_scans(args.batch, POINTRCNN_DYNAMIC_OBJ_NUM_POINTS, 0)).cuda()

    def forward():
        return api.post_process(api.apply_eval(model, cfg, points), cfg)

    for _ in range(2):
        forward()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = [e for e in prof.key_averages() if _device_us(e) > 0 and e.device_type.name == "CUDA"]
    kernel_ms = sum(_device_us(e) for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    groups: dict[str, float] = {}
    for e in kernels:
        name = next((g for g, pat in GROUPS if re.search(pat, e.key)), "other")
        groups[name] = groups.get(name, 0.0) + _device_us(e) / 1e3
    top = sorted(kernels, key=_device_us, reverse=True)[:15]
    port_trace.enable()
    try:
        with torch.profiler.profile(activities=acts) as traced:
            forward()
            torch.cuda.synchronize()
    finally:
        counts = port_trace.disable()
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    trace = out_dir / "profile_eval_trace.json"
    traced.export_chrome_trace(str(trace))
    with tempfile.TemporaryDirectory(dir=out_dir) as root:
        loader = profile_loader(Path(root), args.batch, LOADER_WORKERS, "cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({
        "batch": args.batch, "points_per_scan": POINTRCNN_DYNAMIC_OBJ_NUM_POINTS,
        "wall_ms": wall_ms, "kernel_ms": kernel_ms, "busy_share": kernel_ms / wall_ms,
        "kernel_launches": launches,
        "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": e.key[:90], "ms": _device_us(e) / 1e3, "count": e.count}
                        for e in top],
        "traced": {"spans": span_table(traced), "counters": counts},
        "loader": loader, "trace": str(trace), "card": card,
    }))


if __name__ == "__main__":
    main()
