#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py

Four paths, each at full size from fixed seeds:

* the flagship detector's eval forward plus post-processing (PointRCNN,
  configs/models/lyft_models/pointrcnn_dynamic_obj.yaml, 12288 points per
  scan, random weights);
* the label-free seed path: the PP-score CLI (pre_compute_pp_score) over a
  synthetic multi-traversal dataset written to a temporary directory (5
  traversals of 8 frames and 16 origin frames of ~89.6k points, the
  bench_pipeline.py recipe), then the seed-mask CLI (generate_mask) on those
  scores in groups of 4 frames;
* the windowed kNN (nearest_k) at the flagship backbone's four kNN shapes,
  B = 4, through modest_tpu_torch/tools/knn_bench.py;
* the label-table gathers (take, take_along_axis) at the DBSCAN gather
  probe's sizes, through modest_tpu_torch/tools/gather_probe.py.

Phases, each printing one JSON line:

1. build the hand-written CUDA kernels from modest_tpu_torch/csrc, one nvcc
   per source, all at once;
2. hold FPS against its plain PyTorch version at every shape the forward
   gives it (indices must be equal), with both times;
3. run the forward + post_process on 4 synthetic scans (the bench.py scene
   recipe) and check the output, the FPS launch count and the stage times;
4. compare the card's final boxes on one scan with the port's own CPU
   forward (>= 98% must match 1:1);
5. run the PP-score CLI on the card: origins/s, radius-count launches per
   origin, stage split, peak memory; the scores must be finite and rank the
   ephemeral clusters below the ground;
6. run the seed-mask CLI on the card: frames/s, DBSCAN launches, stage
   split, seed boxes (must be > 0);
7. hold the radius count against its plain version at the PP path's shape
   (0 mismatches), and the DBSCAN edge and propagation kernels against
   theirs on a group of 4 full-size frames (equal rows, core flags, labels);
8. card vs CPU on the seed path: the transformed, sorted PP inputs equal,
   PP counts equal on every 4th query tile, and one frame's seed labels
   (>= 99.9% up to the cluster-id permutation) and boxes (1:1, centre
   < 1 cm) equal;
9. run tools/knn_bench.py: per shape the certificate, the slot match
   against the dense exact path (>= 99.9% where certified), the dense
   fallbacks and the windowed and dense times; then hold the kNN kernel
   against its plain version on the same windows (packed keys equal);
10. run tools/gather_probe.py (every probe's result checked); then hold both
   gather kernels against their plain versions at the probe's shapes
   (equal), with the one PyTorch call for each timed beside them, and check
   that an index outside the table is refused;
11. list the kernels with their launches on the main paths, errors and
   times. Each path's launch counts are set to 0 just before it and read
   just after.

Then the card's name and power limit (nvidia-smi) and, last, the result line.
Any failed check exits non-zero before the result line. Imports torch,
numpy and the repository's modest_tpu_torch package, nothing else.
"""
from __future__ import annotations

import json
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
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
KERNEL_SOURCES = ("fps", "radius_count", "dbscan", "knn", "gather")
# seed path: the PP dataset (bench_pipeline.py sizes) and the seed-mask groups
PP_TRAVERSALS, PP_FRAMES_PER_TRAVERSAL, PP_ORIGINS = 5, 8, 16
FRAME = {"n_ground": 60000, "n_objects": 12, "n_wall": 20000}  # tools/pipeline_scenes.synth_frame
SEED_GROUP = 4
PP_RADIUS = 0.3
# radius count work per pair test: 3 sub, 3 mul, 2 add, 1 compare, 1 add
RC_OPS_PER_PAIR = 10
CPU_TILE_STRIDE = 4  # the CPU side of the PP card-vs-CPU check counts every 4th query tile
# windowed kNN work per pair: 3 sub, 3 mul, 2 add, the key's and, or
KNN_OPS_PER_PAIR = 10
KNN_ITERS = 10     # timed calls per shape in tools/knn_bench.py
GATHER_ITERS = 10  # timed calls per probe in tools/gather_probe.py
SECTOR_BYTES = 32  # the smallest piece of device memory a read moves
MIN_SLOT_MATCH_PCT = 99.9


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_device_ms(fn, reps: int, kernel: str):
    """Device time per call of the CUDA kernels whose name holds ``kernel``
    over ``reps`` calls of ``fn``, by torch.profiler: the kernel alone,
    without the host time between launches that ``device_ms`` sees when a
    call is shorter than its launch. None when the profiler records no
    device time for it (``device_ms`` stays the kernel's time then)."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for evt in prof.key_averages():
        if kernel in evt.key and evt.device_type.name == "CUDA":
            dev_us = getattr(evt, "self_device_time_total", None)
            total_us += float(dev_us if dev_us is not None else evt.self_cuda_time_total)
    return total_us / 1e3 / reps if total_us > 0 else None


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
    from modest_tpu_torch.utils.device import device_ms

    rows = {}
    for stage, b, n, npoint in FPS_PATH_SHAPES + FPS_EXTRA_SHAPES:
        x = inputs[stage]
        dev = x.device
        got = furthest_point_sample_cuda(x, npoint)
        want = furthest_point_sample_plain(x, npoint)
        torch.cuda.synchronize()
        mismatches = int((got != want).sum())
        max_abs_err = int((got.long() - want.long()).abs().max())
        ms = device_ms(lambda: furthest_point_sample_cuda(x, npoint), dev, 10)
        plain_ms = device_ms(lambda: furthest_point_sample_plain(x, npoint), dev, 1)
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
    counts = furthest_point_sample_cuda.launches  # per kernel
    counts.update(dict.fromkeys(counts, 0))
    final = run_path(api, model, cfg, points)
    torch.cuda.synchronize()
    kernel_launches = dict(counts)
    launches = sum(kernel_launches.values())
    # SA1-3 (N >= 1024) take the block kernel; SA4 and the RoI tower the warp kernel
    if kernel_launches != {"fps_block_kernel": 3, "fps_warp_kernel": 3}:
        fail(f"one forward launched the fps kernels {kernel_launches} times, not 3 and 3")
    detections = check_final(torch, final, BATCH, "forward on the card")

    events = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((name, ev))

    stage_ms = {name: 0.0 for name in (*STAGES, "post_nms")}
    forward_ms = []
    torch.cuda.reset_peak_memory_stats(dev)
    counts.update(dict.fromkeys(counts, 0))
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
    if sum(counts.values()) != 6 * TIMED_ITERS:
        fail(f"{TIMED_ITERS} forwards launched the fps kernels {counts} times")
    check_final(torch, final, BATCH, "timed forward on the card")
    emit({"phase": "forward", "batch": BATCH, "points_per_scan": N_POINTS,
          "fps_launches_per_forward": launches, "fps_kernel_launches": kernel_launches,
          "detections": detections,
          "stage_ms": stage_ms, "forward_ms_median": forward_ms[len(forward_ms) // 2],
          "forward_ms_max": forward_ms[-1], "timed_forwards": TIMED_ITERS,
          "scans_per_s": BATCH * TIMED_ITERS / wall,
          "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9, "card": card})
    return kernel_launches


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


def build_kernels(card):
    """One nvcc per source, all started together."""
    from modest_tpu_torch.ops import _build

    def one(name):
        t0 = time.perf_counter()
        lib = _build.build(name)
        return name, lib, time.perf_counter() - t0

    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        for name, lib, seconds in pool.map(one, KERNEL_SOURCES):
            emit({"phase": "build", "kernel": name, "seconds": seconds,
                  "ptxas": [ln for ln in lib.with_suffix(".log").read_text().splitlines()
                            if "registers" in ln or "spill" in ln], "card": card})


def bound(ops: float, nbytes: float):
    t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def pipeline_overrides(root, data_root, *extra):
    return [f"work_dir={root}", f"data_root={data_root}", *extra]


def origin_ids(root):
    with open(Path(root) / "meta_data/lyft/fw70_2m_train_idx.txt") as f:
        return [int(x) for x in f.read().split()]


def phase_pp_score(torch, np, dev, root, data_root, card):
    """The PP CLI on the card: one warm-up origin, then the other origins
    timed on the host clock with the CLI's defaults (2 origins in flight);
    then all origins again, one at a time, with the stage timer."""
    from modest_tpu_torch.cli import pre_compute_pp_score
    from modest_tpu_torch.ops.radius_count import radius_count_sorted_cuda as rc
    from modest_tpu_torch.utils.device import StageTimer
    from modest_tpu_torch.utils.kitti_io import load_velo_scan

    ov = pipeline_overrides(root, data_root, "device=cuda")
    pre_compute_pp_score.main(ov + [f"total_part={PP_ORIGINS}", "part=0"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    rc.launches = 0
    t0 = time.perf_counter()
    pre_compute_pp_score.main(ov)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rc.launches
    timed = PP_ORIGINS - 1
    if launches != timed:
        fail(f"{timed} PP origins launched the radius-count kernel {launches} times")
    peak = torch.cuda.max_memory_allocated(dev) / 1e9

    timer = StageTimer(dev)
    t1 = time.perf_counter()
    pre_compute_pp_score.main(ov + [f"data_paths.pp_score_path={root}/pp_staged",
                                    "pipeline_workers=1"], timer=timer)
    staged_wall = time.perf_counter() - t1

    pp_dir = Path(root) / "intermediate_results/lyft_pp_score_fw70_2m_r0.3"
    ground, objects = [], []
    for gid in origin_ids(root):
        pp = np.load(pp_dir / f"{gid:06d}.npy")
        n = load_velo_scan(Path(data_root) / "velodyne" / f"{gid:06d}.bin").shape[0]
        if pp.shape != (n,) or not np.isfinite(pp).all() or pp.min() < -1e-6 or pp.max() > 1 + 1e-6:
            fail(f"PP scores of origin {gid}: shape {pp.shape} for {n} points, or out of [0, 1]")
        n_ground = FRAME["n_ground"]
        ground.append(pp[:n_ground].mean())
        objects.append(pp[n_ground:n_ground + 800 * FRAME["n_objects"]].mean())
        staged = np.load(Path(root) / "pp_staged" / f"{gid:06d}.npy")
        if not np.array_equal(pp, staged):
            fail(f"PP scores of origin {gid} differ between the pipelined and the staged run")
    if not max(objects) < min(ground):
        fail(f"PP does not rank the ephemeral clusters ({objects}) below the ground ({ground})")
    row = {"phase": "pp_score", "origins_timed": timed, "origin_points": n,
           "traversals": PP_TRAVERSALS, "frames_per_traversal": PP_FRAMES_PER_TRAVERSAL,
           "origins_per_s": timed / wall, "wall_s": wall,
           "radius_count_launches": launches, "radius_count_launches_per_origin": launches / timed,
           "stage_ms_per_origin": {k: v / PP_ORIGINS for k, v in timer.ms().items()},
           "staged_origins_per_s": PP_ORIGINS / staged_wall,
           "peak_mem_gb": peak, "pp_ground_mean": float(np.mean(ground)),
           "pp_objects_mean": float(np.mean(objects)), "card": card}
    emit(row)
    return row


def phase_seed_labels(torch, np, dev, root, data_root, card):
    """The seed-mask CLI on the card over the PP scores: one warm-up group,
    then the other group timed with the CLI's defaults; then all frames
    again, one group at a time, with the stage timer."""
    from modest_tpu_torch.cli import generate_mask
    from modest_tpu_torch.ops import dbscan as D
    from modest_tpu_torch.utils.device import StageTimer

    ov = pipeline_overrides(root, data_root, "device=cuda", f"device_batch_frames={SEED_GROUP}")
    generate_mask.main(ov + [f"total_part={PP_ORIGINS // SEED_GROUP}", "part=0"])  # one group
    torch.cuda.synchronize()
    for fn in (D.dbscan_edge_cuda, D.dbscan_prop_cuda):
        fn.launches = fn.calls = 0
    D.dbscan_prop_cuda.sweeps = D.dbscan_prop_cuda.host_reads = 0
    t0 = time.perf_counter()
    generate_mask.main(ov)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"dbscan_edge": D.dbscan_edge_cuda.launches,
                "dbscan_prop": D.dbscan_prop_cuda.launches}
    calls = {"dbscan_edge": D.dbscan_edge_cuda.calls, "dbscan_prop": D.dbscan_prop_cuda.calls}
    sweeps, host_reads = D.dbscan_prop_cuda.sweeps, D.dbscan_prop_cuda.host_reads
    timed = PP_ORIGINS - SEED_GROUP
    groups = timed // SEED_GROUP
    # per group: kth + edge kernels; 2 kernels per sweep and a border kernel
    if calls != {"dbscan_edge": groups, "dbscan_prop": groups} or launches != {
            "dbscan_edge": 2 * groups, "dbscan_prop": 2 * sweeps + groups}:
        fail(f"{groups} seed groups called the DBSCAN wrappers {calls} times and launched "
             f"{launches} kernels in {sweeps} sweeps")

    timer = StageTimer(dev)
    t1 = time.perf_counter()
    generate_mask.main(ov + [f"data_paths.seg_save_dst={root}/seg_staged",
                             f"data_paths.bbox_info_save_dst={root}/bbox_staged",
                             "pipeline_workers=1"], timer=timer)
    staged_wall = time.perf_counter() - t1

    seg_dir = Path(root) / "intermediate_results/lyft_seg_pp_score_fw70_2m_r0.3"
    bbox_dir = Path(root) / "intermediate_results/lyft_bbox_pp_score_fw70_2m_r0.3"
    boxes = 0
    for gid in origin_ids(root):
        seg = np.load(seg_dir / f"{gid:06d}.npy")
        with open(bbox_dir / f"{gid:06d}.pkl", "rb") as f:
            objs = pickle.load(f)
        if seg.max() != len(objs) or not np.array_equal(seg, np.load(Path(root) / "seg_staged"
                                                                     / f"{gid:06d}.npy")):
            fail(f"seed masks of frame {gid}: {seg.max()} clusters for {len(objs)} boxes, "
                 f"or the staged run differs")
        for o in objs:
            if not np.isfinite([*o.t, o.l, o.w, o.h, o.ry]).all():
                fail(f"frame {gid}: a non-finite seed box")
        boxes += len(objs)
    if boxes == 0:
        fail("the seed path made no seed boxes")
    row = {"phase": "seed_labels", "frames_timed": timed, "group": SEED_GROUP,
           "frames_per_s": timed / wall, "wall_s": wall, "dbscan_launches": launches,
           "dbscan_calls": calls, "dbscan_sweeps": sweeps, "dbscan_host_reads": host_reads,
           "dbscan_sweeps_per_group": sweeps / max(groups, 1),
           "stage_ms_per_frame": {k: v / PP_ORIGINS for k, v in timer.ms().items()},
           "staged_frames_per_s": PP_ORIGINS / staged_wall, "seed_boxes": boxes,
           "seed_boxes_per_frame": boxes / PP_ORIGINS, "card": card}
    emit(row)
    return row


def pp_kernel_inputs(torch, dev, data_root, root):
    """The radius count's inputs for the first origin, built by the PP path
    on ``dev``."""
    from modest_tpu_torch.pipeline.pp_score import (FrameCache, TraversalIndex, _cached_pools,
                                                    _sorted_inputs)

    with open(Path(root) / "meta_data/lyft/fw70_2m_train_track_list.pkl", "rb") as f:
        track_list = pickle.load(f)
    with open(Path(root) / "meta_data/lyft/fw70_2m_valid_train_idx_info.pkl", "rb") as f:
        valid_idx = pickle.load(f)
    index = TraversalIndex(data_root, track_list, valid_idx)
    q_pad, coords, n = _cached_pools(index, FrameCache(index._velo, dev), origin_ids(root)[0])
    q_s, t_sorted, lohi, _ = _sorted_inputs(q_pad, *coords, PP_RADIUS)
    return q_s, t_sorted, lohi, n


def phase_radius_count(torch, np, dev, data_root, root, card):
    from modest_tpu_torch.ops.radius_count import (BM, BN, PAD, radius_count_sorted_cuda,
                                                   radius_count_sorted_plain)
    from modest_tpu_torch.pipeline.pp_score import radius2
    from modest_tpu_torch.utils.device import device_ms

    q_s, t_sorted, lohi, n = pp_kernel_inputs(torch, dev, data_root, root)
    r2 = radius2(PP_RADIUS)
    got = radius_count_sorted_cuda(q_s, t_sorted, lohi, r2)
    want = radius_count_sorted_plain(q_s, t_sorted, lohi, r2)
    torch.cuda.synchronize()
    mismatches = int((got != want).sum())
    max_abs_err = int((got.long() - want.long()).abs().max())
    ms = device_ms(lambda: radius_count_sorted_cuda(q_s, t_sorted, lohi, r2), dev, 10)
    plain_ms = device_ms(lambda: radius_count_sorted_plain(q_s, t_sorted, lohi, r2), dev, 1)
    t_count, _, m = t_sorted.shape
    nq_total = q_s.shape[1]
    lo, hi = lohi[..., 0].long(), lohi[..., 1].long()
    tiles = hi - lo  # (T, nq) pool tiles per query tile
    pairs = int(tiles.sum()) * BM * BN  # the pair tests the kernel makes
    mixed = (n - 1) // BN if n % BN else None  # the tile that mixes real and pad queries
    mixed_pairs = int(tiles[:, mixed].sum()) * BM * BN if mixed is not None else 0
    # the pair tests the count needs: real queries x real pool points of each
    # window (pads sort to the end of the queries and of each pool)
    real_q = (n - torch.arange(nq_total // BN, device=dev) * BN).clamp(0, BN)
    m_real = (t_sorted[:, 0] < PAD).sum(dim=1, keepdim=True)
    real_pool = (torch.minimum(hi * BM, m_real) - lo * BM).clamp_min(0)
    needed = int((real_q * real_pool).sum())
    nbytes = 3 * nq_total * 4 + t_count * 3 * m * 4 + lohi.numel() * 4 + t_count * nq_total * 4
    bound_ms, bound_by = bound(needed * RC_OPS_PER_PAIR, nbytes)
    row = {"phase": "radius_count_vs_plain", "queries": n, "Nq": nq_total, "T": t_count, "M": m,
           "mismatches": mismatches, "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
           "pair_tests": pairs, "pair_tests_needed": needed,
           "pad_pair_share": 1 - needed / max(pairs, 1), "mixed_tile_pair_tests": mixed_pairs,
           "mixed_tile_share": mixed_pairs / max(pairs, 1),
           "pair_tests_per_s": pairs / (ms * 1e-3), "card": card}
    emit(row)
    if mismatches:
        fail(f"radius count kernel disagrees with its plain version on {mismatches} counts")
    return row, (q_s, t_sorted, lohi, got, n)


def seed_group_graph(torch, np, dev, data_root, root):
    """The kNN graph the seed path builds for its first group of frames."""
    from modest_tpu_torch.cli.common import load_pipeline_config
    from modest_tpu_torch.pipeline.clustering import _knn_graph, _prepare_group
    from modest_tpu_torch.pipeline.seed_labels import _frame_final_mask
    from modest_tpu_torch.utils.kitti_io import load_velo_scan

    cfg = load_pipeline_config("generate_mask", pipeline_overrides(root, data_root))
    pp_dir = Path(root) / "intermediate_results/lyft_pp_score_fw70_2m_r0.3"
    group = []
    for gid in origin_ids(root)[:SEED_GROUP]:
        ptc = load_velo_scan(Path(data_root) / "velodyne" / f"{gid:06d}.bin")
        pp = np.load(pp_dir / f"{gid:06d}.npy")
        m = _frame_final_mask(ptc, cfg)
        group.append((ptc[m, :3], pp[m]))
    preps, ns, n_pad, k, kc, w = _prepare_group(group, cfg.graph.n_neighbors, cfg.graph.radius,
                                                1024)
    idx, d2, pb, vb = _knn_graph(preps, n_pad, k, kc, w, cfg.graph.radius, dev)
    return cfg, (idx, d2, pb, vb), ns, n_pad, k, w


def phase_dbscan(torch, np, dev, data_root, root, card):
    from modest_tpu_torch.ops import dbscan as D
    from modest_tpu_torch.pipeline.clustering import dbscan_params
    from modest_tpu_torch.utils.device import device_ms

    cfg, (idx, d2, pb, vb), ns, n_pad, k, w = seed_group_graph(torch, np, dev, data_root, root)
    args = (idx, d2, pb, vb, *dbscan_params(cfg.graph.radius, cfg.clustering.DBSCAN.eps),
            cfg.clustering.DBSCAN.min_samples)
    graph, graph_p = D.dbscan_edge_cuda(*args), D.dbscan_edge_plain(*args)
    sweeps0, reads0 = D.dbscan_prop_cuda.sweeps, D.dbscan_prop_cuda.host_reads
    raw, raw_p = D.dbscan_prop_cuda(graph), D.dbscan_prop_plain(graph_p)
    sweeps = D.dbscan_prop_cuda.sweeps - sweeps0
    host_reads = D.dbscan_prop_cuda.host_reads - reads0
    torch.cuda.synchronize()
    nbr_mm = int((graph.nbr != graph_p.nbr).sum())
    core_mm = int((graph.core != graph_p.core).sum())
    lab_mm = int((raw != raw_p).sum())
    edge_ms = device_ms(lambda: D.dbscan_edge_cuda(*args), dev, 10)
    edge_plain_ms = device_ms(lambda: D.dbscan_edge_plain(*args), dev, 3)
    prop_ms = device_ms(lambda: D.dbscan_prop_cuda(graph), dev, 10)
    prop_plain_ms = device_ms(lambda: D.dbscan_prop_plain(graph_p), dev, 1)
    b, n = graph.core.shape
    total = b * n
    rows = total * k * 4
    edges = int((graph.nbr >= 0).sum())
    # edge: idx and d2 rows and pp, valid read once; nbr rows, core, labels written once
    edge_bound = bound(0, 2 * rows + total * (4 + 1) + rows + total * (1 + 4))
    # prop, what the function needs (not the sweeps this algorithm makes): the
    # nbr rows of valid points once (core rows to propagate, the others for
    # their border labels), one 4-byte label gather per edge, the initial
    # label table and core and valid flags read once, the labels written once
    valid_rows = int(graph.valid.sum()) * k * 4
    prop_bound = bound(0, valid_rows + 4 * edges + total * (4 + 1 + 1) + 4 * total)
    row = {"phase": "dbscan_vs_plain", "frames": b, "in_range_points": ns, "N": n, "k": k,
           "window": w, "edges": edges, "core": int(graph.core.sum()),
           "clusters": int(sum(len(np.unique(r[r >= 0])) for r in raw.cpu().numpy())),
           "nbr_mismatches": nbr_mm, "core_mismatches": core_mm, "label_mismatches": lab_mm,
           "sweeps": sweeps, "host_reads": host_reads, "edge_ms": edge_ms,
           "edge_plain_ms": edge_plain_ms,
           "edge_bound_ms": edge_bound[0], "prop_ms": prop_ms, "prop_plain_ms": prop_plain_ms,
           "prop_bound_ms": prop_bound[0], "bound_by": "bytes", "library_ms": None,
           "card": card}
    emit(row)
    if nbr_mm or core_mm or lab_mm:
        fail(f"DBSCAN kernels disagree with their plain versions: {nbr_mm} edge slots, "
             f"{core_mm} core flags, {lab_mm} labels")
    return row


def match_centres(np, boxes, ref, tol=1e-2):
    used = np.zeros(len(ref), bool)
    pairs = 0
    for b in boxes:
        d = np.linalg.norm(ref - b, axis=1) if len(ref) else np.zeros(0)
        cand = np.flatnonzero((d < tol) & ~used)
        if len(cand):
            used[cand[np.argmin(d[cand])]] = True
            pairs += 1
    return pairs


def phase_pipeline_card_vs_cpu(torch, np, dev, data_root, root, rc_state, card):
    """Seed path on the card vs the port's CPU run: the PP kernel inputs are
    built again on the CPU and must be equal, the CPU counts every 4th query
    tile with the plain twin, and one frame goes through generate_mask on
    both devices."""
    from modest_tpu_torch.cli.common import load_pipeline_config
    from modest_tpu_torch.ops.radius_count import BN, radius_count_sorted_plain
    from modest_tpu_torch.pipeline.pp_score import radius2
    from modest_tpu_torch.pipeline.seed_labels import generate_mask_for_frame
    from modest_tpu_torch.utils.kitti_io import Calibration, load_velo_scan

    q_s, t_sorted, lohi, got, n = rc_state
    t0 = time.perf_counter()
    c_q, c_t, c_lohi, _ = pp_kernel_inputs(torch, torch.device("cpu"), data_root, root)
    inputs_equal = (torch.equal(c_q, q_s.cpu()) and torch.equal(c_t, t_sorted.cpu())
                    and torch.equal(c_lohi, lohi.cpu()))
    nq = q_s.shape[1] // BN
    tiles = torch.arange(0, nq, CPU_TILE_STRIDE)
    cols = (tiles[:, None] * BN + torch.arange(BN)).reshape(-1)
    want = radius_count_sorted_plain(c_q[:, cols].contiguous(), c_t,
                                      c_lohi[:, tiles].contiguous(), radius2(PP_RADIUS))
    count_mm = int((got.cpu()[:, cols] != want).sum())
    pp_cpu_s = time.perf_counter() - t0

    cfg = load_pipeline_config("generate_mask", pipeline_overrides(root, data_root))
    gid = origin_ids(root)[0]
    ptc = load_velo_scan(Path(data_root) / "velodyne" / f"{gid:06d}.bin")
    pp = np.load(Path(root) / "intermediate_results/lyft_pp_score_fw70_2m_r0.3" / f"{gid:06d}.npy")
    calib = Calibration(str(Path(data_root) / "calib" / f"{gid:06d}.txt"))
    lab_g, objs_g = generate_mask_for_frame(ptc, pp, calib, cfg, device="cuda")
    t1 = time.perf_counter()
    lab_c, objs_c = generate_mask_for_frame(ptc, pp, calib, cfg, device="cpu")
    seed_cpu_s = time.perf_counter() - t1
    # labels up to a permutation of the cluster ids: map each card id to the
    # CPU id most of its points carry, one to one
    mapping = {}
    for g in np.unique(lab_g):
        vals, cnt = np.unique(lab_c[lab_g == g], return_counts=True)
        mapping[int(g)] = int(vals[np.argmax(cnt)])
    injective = len(set(mapping.values())) == len(mapping)
    agree = float((np.vectorize(mapping.get)(lab_g) == lab_c).mean()) if injective else 0.0
    centres_g = np.array([o.t for o in objs_g]).reshape(-1, 3)
    centres_c = np.array([o.t for o in objs_c]).reshape(-1, 3)
    matched = match_centres(np, centres_g, centres_c)
    row = {"phase": "pipeline_card_vs_cpu", "origin": gid, "pp_inputs_equal": inputs_equal,
           "pp_count_mismatches": count_mm, "pp_cut": f"CPU counts query tiles i % "
           f"{CPU_TILE_STRIDE} == 0 ({len(tiles)} of {nq} tiles), all {t_sorted.shape[0]} "
           f"traversals", "pp_cpu_s": pp_cpu_s, "seed_points": int(len(lab_g)),
           "label_agreement": agree, "card_boxes": len(objs_g), "cpu_boxes": len(objs_c),
           "boxes_matched": matched, "seed_cpu_s": seed_cpu_s, "card": card}
    emit(row)
    if not inputs_equal or count_mm:
        fail(f"PP card vs CPU: inputs equal {inputs_equal}, {count_mm} count mismatches")
    if agree < 0.999 or matched != len(objs_g) or len(objs_g) != len(objs_c) or not objs_g:
        fail(f"seed card vs CPU: label agreement {agree}, boxes {matched} matched of "
             f"{len(objs_g)} card / {len(objs_c)} CPU")


def phase_knn(torch, dev, card):
    """The windowed kNN's path: tools/knn_bench.py at its four shapes, B = 4
    (nearest_k with the dense fallback, the checks, the timed calls)."""
    from modest_tpu_torch.ops import knn
    from modest_tpu_torch.tools import knn_bench

    knn.knn_windows_cuda.launches = 0
    knn.nearest_k.dense_fallbacks = 0
    rows = knn_bench.run(dev, batch=BATCH, iters=KNN_ITERS)
    torch.cuda.synchronize()
    launches, fallbacks = knn.knn_windows_cuda.launches, knn.nearest_k.dense_fallbacks
    # per shape: nearest_k, the checked run, a warm-up and the timed runs
    if launches != len(rows) * (3 + KNN_ITERS):
        fail(f"tools/knn_bench.py launched the knn kernel {launches} times over {len(rows)} "
             f"shapes")
    for row in rows:
        emit({"phase": "knn", **row, "card": card})
        if row["certificate"] and row["slot_match_pct"] < MIN_SLOT_MATCH_PCT:
            fail(f"knn {row['tag']}: slot match {row['slot_match_pct']}% < {MIN_SLOT_MATCH_PCT}%")
        if row["dense_fallbacks"] != (0 if row["certificate"] else 1):
            fail(f"knn {row['tag']}: certificate {row['certificate']} but "
                 f"{row['dense_fallbacks']} dense fallbacks")
    return rows, launches, fallbacks


def phase_knn_vs_plain(torch, np, dev, card):
    """The kNN kernel against its plain twin on the window inputs nearest_k
    builds at the four shapes: packed keys equal."""
    from modest_tpu_torch.ops import knn
    from modest_tpu_torch.tools import knn_bench
    from modest_tpu_torch.utils.device import device_ms

    rows = []
    for case in knn_bench.shape_cases(BATCH):
        new_xyz = torch.from_numpy(case["new_xyz"]).to(dev)
        xyz = torch.from_numpy(case["xyz"]).to(dev)
        k, w = case["k"], knn._pick_window(case["n"])
        args = knn.sorted_windows(new_xyz, xyz, w, case["radius"])["args"]
        got = knn.knn_windows_cuda(*args, w=w, k=k, frames=BATCH)
        want = knn.knn_windows_plain(*args, w=w, k=k, frames=BATCH)
        torch.cuda.synchronize()
        mismatches = int((got != want).sum())
        max_abs_err = int((got.long() - want.long()).abs().max())
        errors = torch.zeros(1, dtype=torch.int32, device=dev)

        def launch():
            return knn.knn_windows_cuda(*args, w=w, k=k, frames=BATCH, errors=errors)

        ms = device_ms(launch, dev, 10)
        kernel_ms = kernel_device_ms(launch, 10, "knn_window_kernel")
        if int(errors.item()):
            fail(f"knn kernel at {case['tag']}: a window outside its frame")
        plain_ms = device_ms(lambda: knn.knn_windows_plain(*args, w=w, k=k, frames=BATCH), dev, 3)
        bm, bn = BATCH * case["m"], BATCH * case["n"]
        pairs = bm * w
        nbytes = 3 * bm * 4 + 3 * bn * 4 + (bm // knn.QC) * 4 + bm * k * 4
        bound_ms, bound_by = bound(pairs * KNN_OPS_PER_PAIR, nbytes)
        row = {"phase": "knn_vs_plain", "tag": case["tag"], "B": BATCH, "M": case["m"],
               "N": case["n"], "k": k, "window": w, "pairs": pairs, "mismatches": mismatches,
               "max_abs_err": max_abs_err, "ms": ms, "kernel_device_ms": kernel_ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None, "card": card}
        emit(row)
        if mismatches:
            fail(f"knn kernel disagrees with its plain version at {case['tag']}: "
                 f"{mismatches} keys")
        rows.append(row)
    # a window that leaves its frame is refused, not read
    bad = args[-1].clone()
    bad[-1] = 0  # the last chunk belongs to the last frame
    try:
        knn.knn_windows_cuda(*args[:-1], bad, w=w, k=k, frames=BATCH)
    except ValueError:
        pass
    else:
        fail("knn_windows_cuda accepted a window outside its frame")
    return rows


def phase_gather(torch, dev, card):
    """The gathers' path: tools/gather_probe.py at its full size."""
    from modest_tpu_torch.ops import gather
    from modest_tpu_torch.tools import gather_probe

    gather.take_cuda.launches = gather.take_along_axis_cuda.launches = 0
    rows = gather_probe.run(dev, iters=GATHER_ITERS)
    torch.cuda.synchronize()
    launches = {"take": gather.take_cuda.launches,
                "take_along_axis": gather.take_along_axis_cuda.launches}
    for row in rows:
        emit({"phase": "gather_probe", **row, "card": card})
        if not row.get("correct", True):
            fail(f"gather probe {row['probe']} is wrong")
    # take: the small and the full probe, each checked, warmed up and timed;
    # take_along_axis: two tiles, each checked, warmed up and timed
    want = {"take": 2 * (2 + GATHER_ITERS), "take_along_axis": 2 * (2 + GATHER_ITERS)}
    if launches != want:
        fail(f"tools/gather_probe.py launched the gather kernels {launches} times, not {want}")
    return launches


def phase_gather_vs_plain(torch, np, dev, card):
    """Both gather kernels against their plain twins at the probe's shapes,
    with the one PyTorch call that computes each (timed only)."""
    from modest_tpu_torch.ops import gather
    from modest_tpu_torch.tools import gather_probe as gp
    from modest_tpu_torch.utils.device import device_ms

    idx_h, labels_h, _ = gp.probe_data()
    idx = torch.from_numpy(idx_h).to(dev)
    labels = torch.from_numpy(labels_h).to(dev)
    cases = [("take", "full", labels, idx),
             ("take", "small", labels[:1024].contiguous(), (idx[:256] % 1024).contiguous())]
    for r in (8, 256):
        cases.append(("take_along_axis", f"rows_{r}", labels[:gp.W].repeat(r, 1).contiguous(),
                      (idx[:r] % gp.W).contiguous()))
    rows = {}
    for name, probe, tab, ix in cases:
        cuda_fn = getattr(gather, f"{name}_cuda")
        plain_fn = getattr(gather, f"{name}_plain")
        errors = torch.zeros(1, dtype=torch.int32, device=dev)
        got, want = cuda_fn(tab, ix), plain_fn(tab, ix)
        torch.cuda.synchronize()
        mismatches = int((got != want).sum())
        max_abs_err = int((got.long() - want.long()).abs().max())
        ms = device_ms(lambda: cuda_fn(tab, ix, errors), dev, 20)
        kernel_ms = kernel_device_ms(lambda: cuda_fn(tab, ix, errors), 20, f"{name}_kernel")
        gather.raise_on_errors(errors, name)
        plain_ms = device_ms(lambda: plain_fn(tab, ix), dev, 5)
        if name == "take":  # the library call: one index, int32 indices as they are
            library_ms = device_ms(lambda: tab[ix], dev, 20)
        else:  # torch.gather takes only int64 indices: widened beforehand
            ix64 = ix.long()
            library_ms = device_ms(lambda: torch.gather(tab, 1, ix64), dev, 20)
        # idx read and out written once; of the table, the 32-byte sectors
        # this run's indices touch, each read once
        flat = ix.long() if name == "take" else ix.long() + torch.arange(
            ix.shape[0], device=dev)[:, None] * tab.shape[1]
        table_sectors = int(torch.unique(flat // (SECTOR_BYTES // 4)).numel())
        nbytes = ix.numel() * 4 * 2 + table_sectors * SECTOR_BYTES
        bound_ms, bound_by = bound(0, nbytes)
        row = {"phase": "gather_vs_plain", "kernel": name, "probe": probe,
               "table": list(tab.shape), "idx": list(ix.shape),
               "table_sectors_touched": table_sectors, "mismatches": mismatches,
               "max_abs_err": max_abs_err, "ms": ms, "kernel_device_ms": kernel_ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": library_ms, "card": card}
        emit(row)
        if mismatches:
            fail(f"{name} kernel disagrees with its plain version at {probe}: {mismatches}")
        rows[(name, probe)] = row
    # an out-of-range index is refused, not clamped
    bad = idx[:4].clone()
    bad[1, 3] = labels.shape[0]
    try:
        gather.take_cuda(labels, bad)
    except IndexError:
        pass
    else:
        fail("take_cuda accepted an index outside its table")
    return rows


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
    from modest_tpu_torch.tools.pipeline_scenes import write_synth_dataset
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

    build_kernels(card)

    scenes = bench_scans(BATCH, N_POINTS, seed=0)
    fps_rows = phase_fps(torch, fps_inputs(torch, dev, scenes), card)

    cfg = Config(POINTRCNN_DYNAMIC_OBJ)
    model = build_network(cfg, len(POINTRCNN_DYNAMIC_OBJ_CLASS_NAMES), device="cuda", seed=0)
    randomise_bn(torch, model, seed=0)
    fps_launches = phase_forward(torch, dev, api, model, cfg, scenes, card)
    phase_card_vs_cpu(torch, np, api, build_network, model, cfg, scenes, card)

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_pipeline_"))
    try:
        t0 = time.perf_counter()
        root, data_root = write_synth_dataset(
            tmp, traversals=PP_TRAVERSALS, frames_per_traversal=PP_FRAMES_PER_TRAVERSAL,
            origins=PP_ORIGINS, seed=0, **FRAME)
        emit({"phase": "pipeline_dataset", "frames": PP_TRAVERSALS * PP_FRAMES_PER_TRAVERSAL
              + PP_ORIGINS, "seconds": time.perf_counter() - t0, "card": card})
        pp_row = phase_pp_score(torch, np, dev, root, data_root, card)
        seed_row = phase_seed_labels(torch, np, dev, root, data_root, card)
        rc_row, rc_state = phase_radius_count(torch, np, dev, data_root, root, card)
        db_row = phase_dbscan(torch, np, dev, data_root, root, card)
        phase_pipeline_card_vs_cpu(torch, np, dev, data_root, root, rc_state, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    knn_rows, knn_launches, knn_fallbacks = phase_knn(torch, dev, card)
    knn_kernel_rows = phase_knn_vs_plain(torch, np, dev, card)
    gather_launches = phase_gather(torch, dev, card)
    gather_rows = phase_gather_vs_plain(torch, np, dev, card)

    fps_kernels = []
    for kernel, replaces, stages in (
            ("fps_block_kernel", "modest_tpu/ops/pallas_fps.py:146",
             ("backbone_sa1", "backbone_sa2", "backbone_sa3")),
            ("fps_warp_kernel", "modest_tpu/ops/pallas_fps.py:157",
             ("backbone_sa4", "roi_sa1", "roi_sa2"))):
        path = [fps_rows[stage] for stage in stages]
        fps_kernels.append({
            "name": kernel, "route": "cuda", "source": "modest_tpu_torch/csrc/fps.cu",
            "replaces": replaces, "launches": fps_launches[kernel],
            "max_abs_err": max(r["max_abs_err"] for r in path),
            "mismatches": sum(r["mismatches"] for r in path),
            "ms": sum(r["ms"] for r in path), "plain_ms": sum(r["plain_ms"] for r in path),
            "bound_ms": sum(r["bound_ms"] for r in path), "bound_by": "operations",
            "library_ms": None,
            "shapes": f"sum over the FPS calls {', '.join(stages)} of one B=4 forward"})
    emit({"kernels": [*fps_kernels, {
        "name": "radius_count", "route": "cuda", "source": "modest_tpu_torch/csrc/radius_count.cu",
        "replaces": "modest_tpu/ops/pallas_radius_count.py:81",
        "launches": pp_row["radius_count_launches"], "max_abs_err": rc_row["max_abs_err"],
        "mismatches": rc_row["mismatches"], "ms": rc_row["ms"], "plain_ms": rc_row["plain_ms"],
        "bound_ms": rc_row["bound_ms"], "bound_by": rc_row["bound_by"], "library_ms": None,
        "shapes": f"one PP origin: {rc_row['queries']} queries, T={rc_row['T']}, "
                  f"M={rc_row['M']}; launches over {pp_row['origins_timed']} origins",
    }, {
        "name": "dbscan_edge", "route": "cuda", "source": "modest_tpu_torch/csrc/dbscan.cu",
        "replaces": "modest_tpu/ops/pallas_dbscan.py:75",
        "launches": seed_row["dbscan_launches"]["dbscan_edge"],
        "calls": seed_row["dbscan_calls"]["dbscan_edge"], "max_abs_err": 0 if not (
            db_row["nbr_mismatches"] or db_row["core_mismatches"]) else None,
        "mismatches": db_row["nbr_mismatches"] + db_row["core_mismatches"],
        "ms": db_row["edge_ms"], "plain_ms": db_row["edge_plain_ms"],
        "bound_ms": db_row["edge_bound_ms"], "bound_by": "bytes", "library_ms": None,
        "shapes": f"one group of {db_row['frames']} frames, N={db_row['N']}, k={db_row['k']}; "
                  f"launches over {seed_row['frames_timed']} frames",
    }, {
        "name": "dbscan_prop", "route": "cuda", "source": "modest_tpu_torch/csrc/dbscan.cu",
        "replaces": "modest_tpu/ops/pallas_dbscan.py:117",
        "launches": seed_row["dbscan_launches"]["dbscan_prop"],
        "calls": seed_row["dbscan_calls"]["dbscan_prop"],
        "host_reads": seed_row["dbscan_host_reads"], "sweeps": seed_row["dbscan_sweeps"],
        "max_abs_err": 0 if not db_row["label_mismatches"] else None,
        "mismatches": db_row["label_mismatches"],
        "ms": db_row["prop_ms"], "plain_ms": db_row["prop_plain_ms"],
        "bound_ms": db_row["prop_bound_ms"], "bound_by": "bytes", "library_ms": None,
        "shapes": f"the same group, {db_row['sweeps']} sweeps to the fixpoint; launches, "
                  f"calls, host reads and sweeps over {seed_row['frames_timed']} frames",
    }, {
        "name": "knn", "route": "cuda", "source": "modest_tpu_torch/csrc/knn.cu",
        "replaces": "modest_tpu/ops/pallas_knn.py:99", "launches": knn_launches,
        "dense_fallbacks": knn_fallbacks,
        "max_abs_err": max(r["max_abs_err"] for r in knn_kernel_rows),
        "mismatches": sum(r["mismatches"] for r in knn_kernel_rows),
        "ms": sum(r["ms"] for r in knn_kernel_rows),
        "kernel_device_ms": None if any(r["kernel_device_ms"] is None for r in knn_kernel_rows)
        else sum(r["kernel_device_ms"] for r in knn_kernel_rows),
        "plain_ms": sum(r["plain_ms"] for r in knn_kernel_rows),
        "bound_ms": sum(r["bound_ms"] for r in knn_kernel_rows), "bound_by": "operations",
        "library_ms": None, "dense_ms": sum(r["dense_ms"] for r in knn_rows),
        "shapes": "sum over the 4 shapes of tools/knn_bench.py at B=4 (SA1, SA2, FP0, FP1); "
                  "launches over its run",
    }, {
        "name": "take", "route": "cuda", "source": "modest_tpu_torch/csrc/gather.cu",
        "replaces": "scripts_dev/gather_probe.py:119", "launches": gather_launches["take"],
        **{key: gather_rows[("take", "full")][key] for key in (
            "max_abs_err", "mismatches", "ms", "kernel_device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")},
        "shapes": "table (131072,), idx (131072, 70); launches over tools/gather_probe.py",
    }, {
        "name": "take_along_axis", "route": "cuda", "source": "modest_tpu_torch/csrc/gather.cu",
        "replaces": "scripts_dev/gather_probe.py:148",
        "launches": gather_launches["take_along_axis"],
        **{key: gather_rows[("take_along_axis", "rows_256")][key] for key in (
            "max_abs_err", "mismatches", "ms", "kernel_device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")},
        "shapes": "tab (256, 4096), idx (256, 70); launches over tools/gather_probe.py",
    }]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
