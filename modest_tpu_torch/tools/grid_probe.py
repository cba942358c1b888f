"""Where the grid detectors' time goes on the card, and what trained them into
a NaN — the measurements behind ``models/layers.py::Conv2d``,
``models/sparse_conv.py::gather_rows`` and ``chip_smoke.py``'s grid schedule.

    python -m modest_tpu_torch.tools.grid_probe convs     # the BEV convs' routes
    python -m modest_tpu_torch.tools.grid_probe sparse    # SECOND's sparse backbone backward
    python -m modest_tpu_torch.tools.grid_probe squeezed  # SECOND on a 16-step one-cycle

``convs`` times each BEV conv shape of the Lyft and KITTI configs and the
CBGS SECOND at B = 4 under
cuDNN's heuristics, its benchmark mode, channels_last and with cuDNN off
(im2col and a GEMM), forward and forward + backward, and prints the route
``Conv2d``'s rule picks beside the faster of cuDNN's default and cuDNN off.
``sparse`` times SECOND's ``VoxelBackBone8x`` forward +
backward at 16000 voxels a scan with an indexing gather and with the
embedding gather the port uses, with the top kernels of each by
torch.profiler. ``squeezed`` trains SECOND for 16 steps of B = 4 with the
one-cycle schedule squeezed into them (``--epochs 4``) on 16 synthetic
full-density scans, in autograd's anomaly mode, and prints every step's
losses and the first backward op that made a NaN. Each prints JSON lines
and the card's name and power limit. Runs on the card only.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import traceback
import types
from pathlib import Path

import numpy as np
import torch

SECOND_GEOMETRY = types.SimpleNamespace(point_cloud_range=[0, -40, -3, 90.4, 40, 1],
                                        voxel_size=[0.05, 0.05, 0.1],
                                        grid_size=[1808, 1600, 40])
# (cin, cout, H, W of the conv's input, stride, padding) of the BEV convs at B = 4
CONV_SHAPES = {
    "second_l1_first": (256, 128, 202, 228, 1, 0),  # after ZeroPad2d(1)
    "second_l1": (128, 128, 200, 226, 1, 1),
    "second_l2_first": (128, 256, 202, 228, 2, 0),
    "second_l2": (256, 256, 100, 113, 1, 1),
    "pointpillar_l1_first": (64, 64, 498, 562, 2, 0),
    "pointpillar_l1": (64, 64, 248, 280, 1, 1),
    "pointpillar_l2_first": (64, 128, 250, 282, 2, 0),
    "pointpillar_l2": (128, 128, 124, 140, 1, 1),
    "pointpillar_l3_first": (128, 256, 126, 142, 2, 0),
    "pointpillar_l3": (256, 256, 62, 70, 1, 1),
    # KITTI's SECOND (200 x 176 BEV), its grouped head's shared conv, and
    # PointPillars (496 x 432 pillars); the CBGS SECOND's 128 x 128 BEV
    "kitti_second_l1_first": (256, 128, 202, 178, 1, 0),
    "kitti_second_l1": (128, 128, 200, 176, 1, 1),
    "kitti_second_l2_first": (128, 256, 202, 178, 2, 0),
    "kitti_second_l2": (256, 256, 100, 88, 1, 1),
    "kitti_multihead_shared": (512, 64, 200, 176, 1, 1),
    "kitti_pointpillar_l1": (64, 64, 248, 216, 1, 1),
    "kitti_pointpillar_l2": (128, 128, 124, 108, 1, 1),
    "kitti_pointpillar_l3": (256, 256, 62, 54, 1, 1),
    "cbgs_second_l1_first": (256, 128, 130, 130, 1, 0),
    "cbgs_second_l1": (128, 128, 128, 128, 1, 1),
    "cbgs_second_l2": (256, 256, 64, 64, 1, 1),
    "cbgs_shared": (512, 64, 128, 128, 1, 1),
    "cbgs_middle": (64, 64, 128, 128, 1, 1),
}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _timed(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def convs(card: str):
    from ..models import layers

    dev = torch.device("cuda")
    modes = ("default", "benchmark", "channels_last", "no_cudnn")
    for name, (cin, cout, h, w, stride, pad) in CONV_SHAPES.items():
        x = torch.rand(4, cin, h, w, device=dev)
        weight = torch.rand(cout, cin, 3, 3, device=dev) * 0.01
        row = {"shape": name, "gflop": 2 * 4 * cin * cout * 9 * ((h + 2 * pad - 3) // stride + 1)
               * ((w + 2 * pad - 3) // stride + 1) / 1e9}
        for mode in modes:
            torch.backends.cudnn.benchmark = mode == "benchmark"
            torch.backends.cudnn.enabled = mode != "no_cudnn"
            xx, ww = x, weight
            if mode == "channels_last":
                xx = x.contiguous(memory_format=torch.channels_last)
                ww = weight.contiguous(memory_format=torch.channels_last)
            with torch.no_grad():
                row[f"{mode}_ms"] = _timed(lambda: torch.nn.functional.conv2d(
                    xx, ww, None, stride, pad))
            xg, wg = xx.clone().requires_grad_(), ww.clone().requires_grad_()
            row[f"{mode}_fwd_bwd_ms"] = _timed(lambda: torch.nn.functional.conv2d(
                xg, wg, None, stride, pad).sum().backward(), 3)
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.enabled = True
        row["route"] = ("cudnn" if layers.conv_uses_cudnn(cin, cout, (h, w), (stride, stride))
                        else "im2col")
        for key in ("ms", "fwd_bwd_ms"):
            row[f"faster_{key}"] = ("cudnn" if row[f"default_{key}"] <= row[f"no_cudnn_{key}"]
                                    else "im2col")
        print(json.dumps({**row, "card": card}), flush=True)


def sparse(card: str):
    from ..configs import SECOND_DYNAMIC_OBJ
    from ..models import build_network
    from ..models import sparse_conv as sc
    from ..models.voxelize import point_voxel_coords, voxelize_sparse
    from ..utils.config import Config

    dev = torch.device("cuda")
    model = build_network(Config(SECOND_DYNAMIC_OBJ), 1, device=dev, dataset=SECOND_GEOMETRY)
    rng = np.random.RandomState(0)
    pts = np.zeros((4, 65536, 4), np.float32)  # ground-like scans with some objects
    pts[..., 0] = rng.uniform(2, 80, (4, 65536))
    pts[..., 1] = rng.uniform(-30, 30, (4, 65536))
    pts[..., 2] = -1.8 + rng.normal(0, 0.05, (4, 65536))
    pts[:, :8000, 2] = rng.uniform(-1.8, 0.5, (4, 8000))
    pts[..., 3] = rng.uniform(0, 1, (4, 65536))
    p = torch.from_numpy(pts).to(dev)
    g = SECOND_GEOMETRY
    coords, valid = point_voxel_coords(p, g.point_cloud_range, g.voxel_size, g.grid_size)
    vc, vf, vv, vk = voxelize_sparse(p, valid, coords, 16000, *g.grid_size)
    shape = (g.grid_size[2] + 1, g.grid_size[1], g.grid_size[0])
    backbone = model.backbone_3d.train()

    def step():
        f = vf.clone().requires_grad_()
        backbone(f, vc, vk, vv, shape).sum().backward()

    def indexing(feats, rows):
        b, v, c = feats.shape
        return torch.cat([feats.reshape(b * v, c), feats.new_zeros(1, c)])[rows]

    embedding = sc.gather_rows
    for name, gather in (("indexing", indexing), ("embedding", embedding)):
        sc.gather_rows = gather
        try:
            ms = _timed(step, 3)
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                step()
                torch.cuda.synchronize()
            top = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)[:4]
            print(json.dumps({"gather": name, "fwd_bwd_ms": ms, "top_kernels_ms": {
                e.key[:60]: e.device_time_total / 1e3 for e in top}, "card": card}), flush=True)
        finally:
            sc.gather_rows = embedding
    backbone.eval()
    with torch.no_grad():
        print(json.dumps({"gather": "embedding", "eval_ms": _timed(
            lambda: backbone(vf, vc, vk, vv, shape)), "card": card}), flush=True)


def squeezed(card: str):
    from ..cli import train as train_cli
    from ..configs import SECOND_DYNAMIC_OBJ_FULL
    from ..data.kitti_dataset import create_kitti_infos
    from ..tools.synth_kitti import make_dataset
    from ..utils.config import Config

    repo = Path(__file__).resolve().parents[2]
    with tempfile.TemporaryDirectory(prefix="grid_probe_") as tmp:
        root = Path(tmp)
        make_dataset(root, n_train=16, n_val=0, seed=0, full_density=True)
        create_kitti_infos(Config(SECOND_DYNAMIC_OBJ_FULL).DATA_CONFIG, ["Dynamic"], root, root,
                           if_val=False)
        torch.autograd.set_detect_anomaly(True, check_nan=True)
        error = None
        try:
            train_cli.main(["--cfg_file", str(repo / "configs/models/lyft_models/"
                                              "second_dynamic_obj.yaml"),
                            "--data_path", str(root), "--batch_size", "4", "--epochs", "4",
                            "--fix_random_seed", "--output_dir", str(root / "out")])
        except RuntimeError as exc:
            error = "".join(traceback.format_exception_only(exc)).strip()
        finally:
            torch.autograd.set_detect_anomaly(False)
        steps = [json.loads(line) for line in open(root / "out" / "metrics.jsonl")]
        print(json.dumps({"steps": steps, "first_nan": error, "card": card}), flush=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in ("convs", "sparse", "squeezed"):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("grid_probe measures the card; no CUDA device here")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    {"convs": convs, "sparse": sparse, "squeezed": squeezed}[argv[0]](card)


if __name__ == "__main__":
    main()
