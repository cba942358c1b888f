#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

The main path is the flagship detector's eval forward plus post-processing
(PointRCNN, configs/models/lyft_models/pointrcnn_dynamic_obj.yaml, 12288
points per scan), at full width with random weights from a fixed seed.
Phases, each printing one JSON line:

1. build the hand-written CUDA kernels from modest_tpu_torch/csrc;
2. hold each kernel against its plain PyTorch version on the card at every
   shape the main path gives it (indices must be equal), with both times;
3. run the forward + post_process on 4 synthetic scans (the bench.py scene
   recipe) and check the output, the kernels' launch counts and the
   per-stage times;
4. compare the card's final boxes on one scan with the port's own CPU
   forward (>= 98% must match 1:1);
5. list the kernels with their launches, errors and times.

Then the card's name and power limit (nvidia-smi) and, last, the result line.
Any failed check exits non-zero before the result line. Imports torch,
numpy and the repository's modest_tpu_torch package, nothing else.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
BATCH = 4
N_POINTS = 12288
TIMED_ITERS = 11
# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# FPS work per point and step: 3 sub, 3 mul, 2 add, 1 min, 1 compare
FPS_OPS_PER_POINT_STEP = 10
# (stage, B, N, npoint) of every FPS call in one forward at B = 4
FPS_PATH_SHAPES = [
    ("backbone_sa1", BATCH, 12288, 4096),
    ("backbone_sa2", BATCH, 4096, 1024),
    ("backbone_sa3", BATCH, 1024, 256),
    ("backbone_sa4", BATCH, 256, 64),
    ("roi_sa1", BATCH * 100, 512, 128),
    ("roi_sa2", BATCH * 100, 128, 32),
]
FPS_EXTRA_SHAPES = [("ragged_n", BATCH, 1000, 100), ("npoint_1", BATCH, 12288, 1)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def fps_bound(b: int, n: int, npoint: int):
    ops = b * max(npoint - 1, 0) * n * FPS_OPS_PER_POINT_STEP
    nbytes = b * n * 3 * 4 + b * npoint * 4
    t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def fps_inputs(torch, dev, scenes):
    """Inputs at the path's shapes: the backbone levels chain FPS on the
    bench scans; the RoI tower gets random clouds of RoI-sized extent."""
    from modest_tpu_torch.ops.fps import furthest_point_sample_plain

    gen = torch.Generator(device="cpu").manual_seed(1)
    xyz = torch.from_numpy(scenes[..., :3]).to(dev).contiguous()
    inputs = {}
    for stage, b, n, npoint in FPS_PATH_SHAPES + FPS_EXTRA_SHAPES:
        if stage.startswith("backbone"):
            inputs[stage] = xyz
            idx = furthest_point_sample_plain(xyz, npoint).long()
            xyz = torch.gather(xyz, 1, idx[..., None].expand(-1, -1, 3)).contiguous()
        elif stage == "npoint_1":
            inputs[stage] = inputs["backbone_sa1"]
        else:
            cloud = (torch.rand(b, n, 3, generator=gen) - 0.5) * torch.tensor([4.0, 2.0, 1.6])
            inputs[stage] = cloud.to(dev).contiguous()
    return inputs


def phase_fps(torch, inputs, card):
    from modest_tpu_torch.ops.fps import furthest_point_sample_cuda, furthest_point_sample_plain

    rows = {}
    for stage, b, n, npoint in FPS_PATH_SHAPES + FPS_EXTRA_SHAPES:
        x = inputs[stage]
        got = furthest_point_sample_cuda(x, npoint)
        want = furthest_point_sample_plain(x, npoint)
        torch.cuda.synchronize()
        mismatches = int((got != want).sum())
        max_abs_err = int((got.long() - want.long()).abs().max())
        ms = cuda_ms(lambda: furthest_point_sample_cuda(x, npoint), 10)
        plain_ms = cuda_ms(lambda: furthest_point_sample_plain(x, npoint), 1)
        bound_ms, bound_by = fps_bound(b, n, npoint)
        row = {"phase": "fps_vs_plain", "stage": stage, "B": b, "N": n, "npoint": npoint,
               "mismatches": mismatches, "max_abs_err": max_abs_err, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None, "card": card}
        emit(row)
        if mismatches:
            fail(f"fps kernel disagrees with its plain version at {stage}: {mismatches} indices")
        rows[stage] = row
    return rows


def randomise_bn(torch, model, seed: int) -> None:
    """Batch-norm running statistics away from the identity (mean U(±0.3),
    var U(0.5, 1.5)), from a seeded generator."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                c = m.num_features
                m.running_mean.copy_((torch.rand(c, generator=gen) - 0.5) * 0.6)
                m.running_var.copy_(torch.rand(c, generator=gen) + 0.5)


def run_path(api, model, cfg, points, on_stage=None):
    out = api.apply_eval(model, cfg, points, on_stage=on_stage)
    return api.post_process(out, cfg)


def check_final(torch, final, b: int, where: str) -> int:
    for key in ("boxes", "scores"):
        if not bool(torch.isfinite(final[key]).all()):
            fail(f"{where}: non-finite {key}")
    if final["boxes"].shape[:2] != final["valid"].shape or final["boxes"].shape[0] != b:
        fail(f"{where}: unexpected output shapes {tuple(final['boxes'].shape)}")
    count = int(final["valid"].sum())
    if count == 0:
        fail(f"{where}: no detections")
    return count


def phase_forward(torch, dev, api, model, cfg, scenes, card):
    from modest_tpu_torch.models.pointrcnn import STAGES
    from modest_tpu_torch.ops.fps import furthest_point_sample_cuda

    points = torch.from_numpy(scenes).to(dev)
    furthest_point_sample_cuda.launches = 0
    final = run_path(api, model, cfg, points)
    torch.cuda.synchronize()
    launches = furthest_point_sample_cuda.launches
    if launches != 6:
        fail(f"one forward launched the fps kernel {launches} times, not 6")
    detections = check_final(torch, final, BATCH, "forward on the card")

    events = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((name, ev))

    stage_ms = {name: 0.0 for name in (*STAGES, "post_nms")}
    forward_ms = []
    torch.cuda.reset_peak_memory_stats(dev)
    furthest_point_sample_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_ITERS):
        t_it = time.perf_counter()
        events.clear()
        mark("start")
        final = run_path(api, model, cfg, points, on_stage=mark)
        mark("post_nms")
        torch.cuda.synchronize()
        forward_ms.append((time.perf_counter() - t_it) * 1e3)
        for (_, a), (name, b) in zip(events, events[1:]):
            stage_ms[name] += a.elapsed_time(b) / TIMED_ITERS
    wall = time.perf_counter() - t0
    forward_ms.sort()
    if furthest_point_sample_cuda.launches != 6 * TIMED_ITERS:
        fail(f"{TIMED_ITERS} forwards launched fps {furthest_point_sample_cuda.launches} times")
    check_final(torch, final, BATCH, "timed forward on the card")
    emit({"phase": "forward", "batch": BATCH, "points_per_scan": N_POINTS,
          "fps_launches_per_forward": launches, "detections": detections,
          "stage_ms": stage_ms, "forward_ms_median": forward_ms[len(forward_ms) // 2],
          "forward_ms_max": forward_ms[-1], "timed_forwards": TIMED_ITERS,
          "scans_per_s": BATCH * TIMED_ITERS / wall,
          "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9, "card": card})
    return launches


def match_1to1(np, boxes, scores, rb, rs):
    """Greedy 1:1 match of tests/test_reference_parity_model.py: center
    < 1 cm, sizes < 2e-3, score < 5e-4."""
    used = np.zeros(len(boxes), bool)
    pairs = []
    for j in range(len(rb)):
        d = np.linalg.norm(boxes[:, :3] - rb[j, :3], axis=1)
        ds = np.abs(boxes[:, 3:6] - rb[j, 3:6]).max(axis=1)
        cand = np.flatnonzero((d < 1e-2) & (ds < 2e-3) & (np.abs(scores - rs[j]) < 5e-4) & ~used)
        if len(cand):
            used[cand[0]] = True
            pairs.append((int(cand[0]), j))
    return pairs


def phase_card_vs_cpu(torch, np, api, build_network, model, cfg, scenes, card):
    cpu_model = build_network(cfg, model.num_class, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    scan = torch.from_numpy(scenes[:1])
    t0 = time.perf_counter()
    want = run_path(api, cpu_model, cfg, scan)
    cpu_s = time.perf_counter() - t0
    got = run_path(api, model, cfg, scan.to(next(model.parameters()).device))

    def valid(final):
        v = final["valid"][0].cpu().numpy()
        return (final["boxes"][0].cpu().numpy()[v], final["scores"][0].cpu().numpy()[v],
                final["labels"][0].cpu().numpy()[v])

    gb, gs, gl = valid(got)
    wb, ws, wl = valid(want)
    pairs = match_1to1(np, gb, gs, wb, ws)
    bad_yaw_or_label = 0
    for a, j in pairs:
        dyaw = abs(float(gb[a, 6]) - float(wb[j, 6])) % (2 * np.pi)
        bad_yaw_or_label += int(min(dyaw, 2 * np.pi - dyaw) >= 2e-3 or gl[a] != wl[j])
    total = max(len(gb), len(wb))
    frac = (len(pairs) - bad_yaw_or_label) / max(total, 1)
    emit({"phase": "card_vs_cpu", "points": N_POINTS, "card_detections": len(gb),
          "cpu_detections": len(wb), "matched": len(pairs) - bad_yaw_or_label,
          "match_frac": frac, "cpu_forward_s": cpu_s, "card": card})
    if total == 0 or frac < 0.98:
        fail(f"card vs CPU: {len(pairs) - bad_yaw_or_label}/{total} final boxes match (< 98%)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script checks the port on an NVIDIA card",
              file=sys.stderr)
        return 2
    if not (REPO / "modest_tpu_torch").is_dir():
        print(f"chip_smoke: no modest_tpu_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import numpy as np

    from modest_tpu_torch.configs import POINTRCNN_DYNAMIC_OBJ, POINTRCNN_DYNAMIC_OBJ_CLASS_NAMES
    from modest_tpu_torch.models import api, build_network
    from modest_tpu_torch.ops import _build
    from modest_tpu_torch.tools.scenes import bench_scans
    from modest_tpu_torch.utils.config import Config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    dev = torch.device("cuda", 0)
    emit({"phase": "setup", "device": torch.cuda.get_device_name(0), "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})

    t0 = time.perf_counter()
    lib = _build.build("fps")
    emit({"phase": "build", "kernel": "fps", "seconds": time.perf_counter() - t0,
          "ptxas": [ln for ln in lib.with_suffix(".log").read_text().splitlines()
                    if "registers" in ln or "spill" in ln]})

    scenes = bench_scans(BATCH, N_POINTS, seed=0)
    fps_rows = phase_fps(torch, fps_inputs(torch, dev, scenes), card)

    cfg = Config(POINTRCNN_DYNAMIC_OBJ)
    model = build_network(cfg, len(POINTRCNN_DYNAMIC_OBJ_CLASS_NAMES), device="cuda", seed=0)
    randomise_bn(torch, model, seed=0)
    launches = phase_forward(torch, dev, api, model, cfg, scenes, card)
    phase_card_vs_cpu(torch, np, api, build_network, model, cfg, scenes, card)

    path = [fps_rows[stage] for stage, *_ in FPS_PATH_SHAPES]
    emit({"kernels": [{
        "name": "fps", "route": "cuda", "source": "modest_tpu_torch/csrc/fps.cu",
        "replaces": "modest_tpu/ops/pallas_fps.py:137", "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in fps_rows.values()),
        "mismatches": sum(r["mismatches"] for r in fps_rows.values()),
        "ms": sum(r["ms"] for r in path), "plain_ms": sum(r["plain_ms"] for r in path),
        "bound_ms": sum(r["bound_ms"] for r in path), "bound_by": "operations",
        "library_ms": None, "shapes": "sum over the 6 FPS calls of one B=4 forward",
    }]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
