"""Where the time of the port's eval forward goes on the card.

    python -m modest_tpu_torch.tools.profile_eval [--batch 4] [--out build/profile]

Runs the flagship PointRCNN eval forward + post_process (12288-point scans,
the bench.py scene recipe, seeded random weights) under ``torch.profiler``
after two warm-up passes, and prints one JSON line: wall time per forward,
summed kernel time, the device's busy share, kernel launches, and the
kernels and kernel groups that take the most device time. The Chrome trace
is written beside it. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import time
from pathlib import Path

import torch

from ..configs import (POINTRCNN_DYNAMIC_OBJ, POINTRCNN_DYNAMIC_OBJ_CLASS_NAMES,
                       POINTRCNN_DYNAMIC_OBJ_NUM_POINTS)
from ..models import api, build_network
from ..utils.config import Config
from .scenes import bench_scans

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
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    trace = out_dir / "profile_eval_trace.json"
    prof.export_chrome_trace(str(trace))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({
        "batch": args.batch, "points_per_scan": POINTRCNN_DYNAMIC_OBJ_NUM_POINTS,
        "wall_ms": wall_ms, "kernel_ms": kernel_ms, "busy_share": kernel_ms / wall_ms,
        "kernel_launches": launches,
        "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": e.key[:90], "ms": _device_us(e) / 1e3, "count": e.count}
                        for e in top],
        "trace": str(trace), "card": card,
    }))


if __name__ == "__main__":
    main()
