"""Shared fixtures of the benchmark's tests.

Tests that need an NVIDIA GPU carry the ``chip`` marker and take the ``card``
fixture, which skips them where no card is visible. Whether there is one is
decided inside the fixture, never at import, so every test process collects
the same tests.
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture(autouse=True, scope="session")
def few_threads():
    """Two intra-op threads a test process: the CPU-sized runs of several
    test processes share the machine's cores."""
    import torch

    torch.set_num_threads(2)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs an NVIDIA GPU; skipped where none is visible")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


@pytest.fixture
def bench_tree(tmp_path):
    """A copy of the benchmark's tree and manifest, for tests that add files
    to it; returns (tree, manifest path, manifest dict)."""
    tree = tmp_path / "bench_h100"
    shutil.copytree(ROOT / "bench_h100", tree, ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    return tree, tmp_path / "BENCHMARK.json", manifest


def add_tiny_cell(tree: Path, manifest: dict, manifest_path: Path, config: str,
                  batch: int = 1, pool: int = 1, compare: int = 1, points: int | None = None,
                  name: str = "tiny", mode: str = "eval") -> str:
    """A cell of ``config`` under a tiny ``mode`` mix (``compare`` batches
    compared, or steps checked; a train mix's compared window step is its
    second), added by new files only, with the limits of
    the configuration's own cell of that mode; ``points`` gives the cell a
    copy of the configuration that samples that many points a scan."""
    mix = ({"mode": "eval", "generator": "traffic/lyft_scans.py", "batch": batch, "pool": pool,
            "compare_batches": compare}
           if mode == "eval" else
           {"mode": "train", "generator": "traffic/kitti_tree.py", "batch": batch,
            "scans": batch * pool, "workers": 2, "check_steps": compare, "compare_within": 2,
            "schedule_scans": 3712})
    (tree / "traffic" / "mixes" / f"{name}.json").write_text(json.dumps(mix))
    own = next(w["name"] for w in manifest["workloads"]
               if w["config"] == config and w["traffic"].startswith(mode))
    shutil.copy(tree / "workloads" / f"{own}.json", tree / "workloads" / f"{name}.json")
    if points is not None:
        cfg = json.loads((tree / "configs" / f"{config}.json").read_text())
        for proc in cfg["DATA_CONFIG"]["DATA_PROCESSOR"]:
            if proc["NAME"] == "sample_points":
                proc["NUM_POINTS"] = {"train": points, "test": points}
        (tree / "configs" / f"{name}_cfg.json").write_text(json.dumps(cfg))
        shutil.copy(tree / "configs" / f"{config}.py", tree / "configs" / f"{name}_cfg.py")
        config = f"{name}_cfg"
    manifest["workloads"].append({"name": name, "config": config, "traffic": name, "chips": 1,
                                  "why": "tiny"})
    for metric in manifest["end_to_end"]:
        if own in metric.get("workloads", ()):
            metric["workloads"].append(name)
    manifest_path.write_text(json.dumps(manifest))
    return name
