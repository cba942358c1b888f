"""Time the small-cloud FPS kernel, the DBSCAN edge stage and the gather
kernels of one tree of the port on inputs that another tree saved: parent
and change on one card.

    python -m modest_tpu_torch.tools.kernel_ab save DIR [fps|dbscan|gather ...]  # from a tree's root
    python -m modest_tpu_torch.tools.kernel_ab time DIR   # one JSON line per input

``save`` builds the inputs by ``chip_smoke.py``'s recipes, every family
unless some are named: FPS clouds at the path's three small-cloud shapes
(``fps_inputs``: SA4 (4, 256→64) from the bench scans, the RoI tower's
(400, 512→128) and (400, 128→32)), the kNN graphs of the seed path's 4
groups of 4 frames (the synthetic dataset, the PP CLI, ``seed_group_graph``)
and the gather probe's tables and indices (``tools/gather_probe.py``'s full
and small take, a uniform and a wide-band take, both take_along_axis
tiles), and writes them with ``torch.save``.
``time`` uses only ``furthest_point_sample_cuda``, ``dbscan_edge_cuda``,
``take_cuda``, ``take_along_axis_cuda``, their plain twins and
``chip_smoke.py``'s timing helpers, so a copy of this file in an older tree
of the port times that tree on the same inputs: CUDA events around 20 calls
(``ms``) and ``torch.profiler``'s device time of each kernel
(``kernel_device_ms``), every result held to its plain twin. Run the trees
in turns (parent, change, change, parent) in one call on the card.
"""
from __future__ import annotations

import json
import shutil
import sys
import tempfile
from pathlib import Path

import torch

REPS = 20
FAMILIES = ("fps", "dbscan", "gather")


def save_fps():
    import chip_smoke as cs
    from modest_tpu_torch.tools.scenes import bench_scans

    dev = torch.device("cuda", 0)
    fps_in = cs.fps_inputs(torch, dev, bench_scans(cs.BATCH, cs.N_POINTS, seed=0))
    return {stage: (fps_in[stage].cpu(), npoint) for stage, _, _, npoint in cs.FPS_PATH_SHAPES
            if stage in cs.FPS_SMALL_STAGES}


def save_dbscan():
    import numpy as np

    import chip_smoke as cs
    from modest_tpu_torch.cli import pre_compute_pp_score
    from modest_tpu_torch.pipeline.clustering import dbscan_params
    from modest_tpu_torch.tools.pipeline_scenes import write_synth_dataset

    dev = torch.device("cuda", 0)
    graphs = {}
    tmp = Path(tempfile.mkdtemp(prefix="kernel_ab_"))
    try:
        root, data_root = write_synth_dataset(
            tmp, traversals=cs.PP_TRAVERSALS, frames_per_traversal=cs.PP_FRAMES_PER_TRAVERSAL,
            origins=cs.PP_ORIGINS, seed=0, **cs.FRAME)
        pre_compute_pp_score.main(cs.pipeline_overrides(root, data_root, "device=cuda"))
        for g in range(cs.PP_ORIGINS // cs.SEED_GROUP):
            cfg, tensors, *_ = cs.seed_group_graph(torch, np, dev, data_root, root, g)
            params = (*dbscan_params(cfg.graph.radius, cfg.clustering.DBSCAN.eps),
                      cfg.clustering.DBSCAN.min_samples)
            graphs[f"seed_group_{g}"] = ([t.cpu() for t in tensors], params)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return graphs


def save_gather():
    """(kernel, table, idx) by probe: the cases of ``chip_smoke.py``'s
    ``gather_cases``."""
    import chip_smoke as cs

    return {probe: (name, tab.cpu(), ix.cpu())
            for name, probe, tab, ix in cs.gather_cases(torch, torch.device("cpu"))}


def save(out: Path, families=FAMILIES) -> None:
    makers = {"fps": save_fps, "dbscan": save_dbscan, "gather": save_gather}
    data = {family: makers[family]() for family in families}
    out.mkdir(parents=True, exist_ok=True)
    torch.save(data, out / "inputs.pt")


def time_inputs(src: Path) -> None:
    import chip_smoke as cs
    from modest_tpu_torch.ops import dbscan as D
    from modest_tpu_torch.ops import gather as G
    from modest_tpu_torch.ops.fps import furthest_point_sample_cuda, furthest_point_sample_plain
    from modest_tpu_torch.utils.device import device_ms

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    data = torch.load(src / "inputs.pt")
    for stage, (x, npoint) in data.get("fps", {}).items():
        x = x.to(dev)

        def fps():
            return furthest_point_sample_cuda(x, npoint)

        mismatches = int((fps() != furthest_point_sample_plain(x, npoint)).sum())
        row = {"tool": "kernel_ab", "kernel": "fps_warp_kernel", "input": stage,
               "shape": [*x.shape[:2], npoint], "mismatches": mismatches,
               "ms": device_ms(fps, dev, REPS),
               "kernel_device_ms": cs.kernel_device_ms(fps, REPS, "fps_warp_kernel"),
               "card": card}
        row["us_per_step"] = row["ms"] * 1e3 / max(npoint - 1, 1)
        print(json.dumps(row), flush=True)
        if mismatches:
            raise SystemExit(f"kernel_ab: fps disagrees with its plain twin at {stage}")
    for name, (tensors, params) in data.get("dbscan", {}).items():
        args = (*[t.to(dev) for t in tensors], *params)

        def edge():
            return D.dbscan_edge_cuda(*args)

        got, want = edge(), D.dbscan_edge_plain(*args)
        mismatches = sum(int((getattr(got, f) != getattr(want, f)).sum())
                         for f in ("nbr", "tie", "core"))
        row = {"tool": "kernel_ab", "kernel": "dbscan_edge", "input": name,
               "shape": list(tensors[0].shape), "mismatches": mismatches,
               "ms": device_ms(edge, dev, REPS),
               "kernel_device_ms": {k: cs.kernel_device_ms(edge, REPS, k)
                                    for k in ("kth_kernel", "edge_kernel")},
               "card": card}
        print(json.dumps(row), flush=True)
        if mismatches:
            raise SystemExit(f"kernel_ab: the edge stage disagrees with its plain twin on {name}")
    for probe, (name, tab, ix) in data.get("gather", {}).items():
        tab, ix = tab.to(dev), ix.to(dev)
        cuda_fn, plain_fn = getattr(G, f"{name}_cuda"), getattr(G, f"{name}_plain")
        errors = torch.zeros(1, dtype=torch.int32, device=dev)

        def gather():
            return cuda_fn(tab, ix, errors)

        mismatches = int((gather() != plain_fn(tab, ix)).sum())
        row = {"tool": "kernel_ab", "kernel": name, "input": probe,
               "table": list(tab.shape), "idx": list(ix.shape), "mismatches": mismatches,
               "ms": device_ms(gather, dev, REPS),
               "kernel_device_ms": cs.kernel_device_ms(gather, REPS, f"{name}_kernel"),
               "card": card}
        G.raise_on_errors(errors, name)
        print(json.dumps(row), flush=True)
        if mismatches:
            raise SystemExit(f"kernel_ab: {name} disagrees with its plain twin on {probe}")


if __name__ == "__main__":
    args = sys.argv[1:]
    if (len(args) < 2 or args[0] not in ("save", "time") or (args[0] == "time" and len(args) > 2)
            or not set(args[2:]) <= set(FAMILIES)):
        raise SystemExit(__doc__)
    sys.path.insert(0, str(Path.cwd()))  # chip_smoke.py at the tree's root
    if args[0] == "save":
        save(Path(args[1]), tuple(args[2:]) or FAMILIES)
    else:
        time_inputs(Path(args[1]))
