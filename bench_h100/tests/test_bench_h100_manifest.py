"""The benchmark is driven by data: a new cell, configuration or per-layer
metric is picked up from new files, with no edit to a file already there;
and ``BENCHMARK.json`` keeps to its contract's shape."""
from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from bench_h100.harness import manifest

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def snapshot(tree: Path) -> dict:
    return {p.relative_to(tree): p.read_bytes() for p in tree.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_alone_add_a_cell_a_configuration_and_a_metric(bench_tree):
    tree, manifest_path, bench = bench_tree
    before = snapshot(tree)
    # a configuration: the flagship's file under a new name, with its recipe
    shutil.copy(tree / "configs" / "pointrcnn_dynamic_obj.json", tree / "configs" / "newcfg.json")
    shutil.copy(tree / "configs" / "pointrcnn_dynamic_obj.py", tree / "configs" / "newcfg.py")
    # a traffic mix and the cell's limits
    (tree / "traffic" / "mixes" / "eval.b2.json").write_text(json.dumps(
        {"mode": "eval", "generator": "traffic/lyft_scans.py", "batch": 2, "pool": 4,
         "compare_batches": 2, "why": "new"}))
    (tree / "workloads" / "newcfg.eval.b2.json").write_text(json.dumps(
        {"limits": {"final_miss": 0.01}}))
    # a per-layer metric
    (tree / "metrics" / "eval.new_ms.py").write_text(
        'LAYER = "new layer"\nMOVES = "eval_scans_per_s"\n\n\ndef read(ctx):\n'
        '    return ctx.stage("backbone")\n')
    bench["configs"].append({"name": "newcfg", "source": "https://example.org/cfg",
                             "file": "bench_h100/configs/newcfg.json", "reduced": [],
                             "why": "new"})
    bench["workloads"].append({"name": "newcfg.eval.b2", "config": "newcfg",
                               "traffic": "eval.b2", "chips": 1, "why": "new"})
    for metric in bench["end_to_end"]:
        if "pointrcnn.eval.b4" in metric.get("workloads", ()):
            metric["workloads"].append("newcfg.eval.b2")
    bench["per_layer"].append({"name": "eval.new_ms", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "new layer",
                               "moves": "eval_scans_per_s", "workloads": ["newcfg.eval.b2"]})
    manifest_path.write_text(json.dumps(bench))

    cell = manifest.load_cell(manifest_path, "newcfg.eval.b2", tree)
    assert cell.config["MODEL"]["NAME"] == "PointRCNN"
    assert cell.recipe.points_per_scan(cell.config, "test") == 12288
    assert cell.traffic["batch"] == 2 and cell.limits["limits"] == {"final_miss": 0.01}
    assert [m["name"] for m in cell.per_layer] == ["eval.new_ms"]
    assert {m["name"] for m in cell.end_to_end} == {
        "eval_scans_per_s", "eval_batch_ms_p90", "setup_s"}
    reader = manifest.metric_reader("eval.new_ms", tree)
    assert reader.LAYER == "new layer"
    # the cells already there are found as before, and no file changed
    assert manifest.load_cell(manifest_path, "pointrcnn.eval.b4", tree).traffic["batch"] == 4
    after = snapshot(tree)
    assert {k: v for k, v in after.items() if k in before} == before


def test_a_mix_naming_a_new_generator_file_is_run_by_it(bench_tree, tmp_path):
    """A traffic mix that names a generator file of its own is served by it,
    with no edit to a file already there."""
    from bench_h100 import run as bench_run
    from conftest import add_tiny_cell

    tree, manifest_path, bench = bench_tree
    before = snapshot(tree)
    marker = tmp_path / "called"
    (tree / "traffic" / "other_scans.py").write_text(
        (tree / "traffic" / "lyft_scans.py").read_text()
        + "\n\n_make_batches = make_batches\n\n\n"
        + "def make_batches(seed, mix, cfg, num_points):\n"
        + f"    open({str(marker)!r}, 'w').write(str(seed))\n"
        + "    return _make_batches(seed, mix, cfg, num_points)\n")
    name = add_tiny_cell(tree, bench, manifest_path, "pointrcnn_dynamic_obj", batch=1,
                         points=4096)
    mix_path = tree / "traffic" / "mixes" / f"{name}.json"
    mix = json.loads(mix_path.read_text())
    mix_path.write_text(json.dumps({**mix, "generator": "traffic/other_scans.py"}))
    cell = manifest.load_cell(manifest_path, name, tree)
    assert cell.generator.__file__ == str(tree / "traffic" / "other_scans.py")
    result = bench_run.run(["--workload", name, "--seed", "7", "--seconds", "0"], device="cpu",
                           benchmark=manifest_path, bench_dir=tree)
    assert marker.read_text() == "7" and result["correct"] is True, result["checks"]
    after = snapshot(tree)
    assert {k: v for k, v in after.items() if k in before} == before


def test_a_generator_outside_the_benchmark_is_refused(bench_tree):
    tree, _, _ = bench_tree
    with pytest.raises(ValueError):
        manifest.load_generator("../run.py", tree / "traffic")


def test_an_unknown_cell_is_refused(bench_tree):
    tree, manifest_path, bench = bench_tree
    manifest_path.write_text(json.dumps(bench))
    with pytest.raises(KeyError):
        manifest.load_cell(manifest_path, "no.such.cell", tree)


def test_every_per_layer_metric_has_a_reader_that_agrees_with_the_manifest():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        reader = manifest.metric_reader(m["name"])
        assert reader.LAYER == m["layer"], m["name"]
        assert reader.MOVES == m["moves"], m["name"]
        assert callable(reader.read)


def test_every_cell_has_its_files_and_reports_what_the_contract_asks():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    for cfg in bench["configs"]:
        assert NAME.match(cfg["name"]) and (ROOT / cfg["file"]).is_file()
        assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in (
            "lower", "higher")
    for w in bench["workloads"]:
        cell = manifest.load_cell(ROOT / "BENCHMARK.json", w["name"])
        assert NAME.match(w["name"]) and len(w["why"]) <= 200 and w["chips"] == 1
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        assert cell.limits["limits"]
