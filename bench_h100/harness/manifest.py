"""Find a cell's pieces by name.

``BENCHMARK.json`` names the cells, configurations and metrics. Each piece
lives in a file of its own, found by its name, so a later change adds a
cell, a configuration or a per-layer metric by adding files:

* ``configs/<config>.json``: the configuration as run; ``configs/<config>.py``:
  how the port and the reference are built from it, and how their outputs
  are compared;
* ``traffic/mixes/<traffic>.json``: the traffic mix's parameters, with the
  generator that reads them under ``"generator"`` (a file under the
  benchmark's tree; an eval mix's offers ``make_batches(seed, mix, cfg,
  num_points)``, a train mix's ``write_dataset(root, seed, mix, cfg)``);
* ``workloads/<cell>.json``: the cell's comparison limits and the readings
  they were set from;
* ``metrics/<metric>.py``: a per-layer metric's reader.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import ``path`` as a module named ``name`` (a metric or config file
    may have dots in its name)."""
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict        # configs/<config>.json
    recipe: object     # configs/<config>.py
    traffic: dict       # traffic/mixes/<traffic>.json
    generator: object   # the file the mix names under "generator"
    limits: dict        # workloads/<cell>.json
    end_to_end: list    # BENCHMARK.json's end-to-end metrics this cell reports
    per_layer: list     # and its per-layer metrics


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(benchmark_path: Path, name: str, bench_dir: Path = BENCH_DIR) -> Cell:
    bench = load_json(benchmark_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {benchmark_path}; have {sorted(cells)}")
    w = cells[name]
    config_name, traffic_name = w["config"], w["traffic"]
    traffic = load_json(bench_dir / "traffic" / "mixes" / f"{traffic_name}.json")
    return Cell(
        name=name, config_name=config_name, traffic_name=traffic_name, chips=int(w["chips"]),
        config=load_json(bench_dir / "configs" / f"{config_name}.json"),
        recipe=load_module(bench_dir / "configs" / f"{config_name}.py",
                            f"bench_h100_config_{config_name}"),
        traffic=traffic, generator=load_generator(traffic["generator"], bench_dir),
        limits=load_json(bench_dir / "workloads" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if reports(m, name)])


def load_generator(relative: str, bench_dir: Path = BENCH_DIR):
    """The traffic generator at ``relative`` under the benchmark's tree."""
    path = (bench_dir / relative).resolve()
    if bench_dir.resolve() not in path.parents:
        raise ValueError(f"a mix's generator lies outside the benchmark: {relative}")
    return load_module(path, f"bench_h100_traffic_{path.stem}")


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    return load_module(bench_dir / "metrics" / f"{name}.py", f"bench_h100_metric_{name}")
