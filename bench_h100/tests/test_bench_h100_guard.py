"""The run's guards: no JAX and no JAX package in the process, no port in the
reference, and no result without a card."""
from __future__ import annotations

import json
import subprocess
import sys
import types
from pathlib import Path

import pytest

from bench_h100 import run as bench_run
from bench_h100.harness import guard

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("names, found", [
    (["modest_tpu_torch", "modest_tpu_torch.models.api", "torch"], []),
    (["modest_tpu", "modest_tpu.ops"], ["modest_tpu"]),
    (["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen"], ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "modest_tpu_torch_extra"], []),
])
def test_forbidden_modules_are_matched_by_whole_top_level_name(names, found):
    assert guard.forbidden_loaded(names) == found


def test_the_reference_imports_nothing_of_the_port():
    assert guard.reference_offenders(ROOT / "bench_h100" / "reference") == {}
    import bench_h100.reference.models  # noqa: F401

    assert guard.reference_modules_clean("bench_h100.reference") == []


def test_a_reference_that_imports_the_port_stops_the_run(bench_tree):
    tree, manifest_path, bench = bench_tree
    manifest_path.write_text(json.dumps(bench))
    target = tree / "reference" / "box_coders.py"
    target.write_text("from modest_tpu_torch.models import box_coders\n" + target.read_text())
    with pytest.raises(bench_run.RunFailed, match="reference imports"):
        bench_run.run(["--workload", "pointrcnn.eval.b4", "--seed", "1", "--seconds", "1"],
                      benchmark=manifest_path, bench_dir=tree)


def test_a_run_without_a_card_fails_and_prints_no_result(tmp_path):
    """The sandbox that runs these tests has no card: the command exits with
    another code than 0 and its standard output stays empty. The same holds
    in a directory with only the benchmark's own files."""
    import shutil

    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible here")
    argv = ["bench_h100/run.py", "--workload", "pointrcnn.eval.b4", "--seed", str(2 ** 31 + 5),
            "--seconds", "1", "--trace", "0"]
    proc = subprocess.run([sys.executable, *argv], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr
    bare = tmp_path / "bare"
    shutil.copytree(ROOT / "bench_h100", bare / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", bare / "BENCHMARK.json")
    proc = subprocess.run([sys.executable, *argv], cwd=bare, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_jax_loaded_by_the_end_of_a_run_fails_it(bench_tree, monkeypatch):
    """A CPU-sized run that would pass fails once a module named jax is in the
    process."""
    from conftest import add_tiny_cell

    tree, manifest_path, bench = bench_tree
    name = add_tiny_cell(tree, bench, manifest_path, "pointrcnn_dynamic_obj")
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(bench_run.RunFailed, match="jax"):
        bench_run.run(["--workload", name, "--seed", str(2 ** 31 + 9), "--seconds", "0"],
                      device="cpu", benchmark=manifest_path, bench_dir=tree)
