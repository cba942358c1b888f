"""Run one benchmark cell once and print its result as one JSON line.

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic mix, its comparison limits and its
per-layer metrics are found by name (``harness/manifest.py``). The run needs
an NVIDIA GPU and fails without one; it sets both TF32 switches off. With
``--trace 0`` it prints the cell's end-to-end metrics, with ``--trace 1``
its per-layer metrics, from stage events and a ``torch.profiler`` pass.
Either way the plain reference then judges the port's outputs of a sample
of the window's batches; the numbers compared, each beside its limit, end
the result line and standard error. The run fails if JAX, jaxlib, flax or
the JAX package ``modest_tpu`` is loaded, or if the reference imports the
port.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# every build and kernel cache at a fixed path inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, str(ROOT / "build" / "bench_h100" / sub))


class RunFailed(Exception):
    pass


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="run one benchmark cell once")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def card(torch, device) -> dict:
    if device.type != "cuda":
        return {"platform": device.type, "kind": device.type, "count": 1}
    import subprocess

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}
    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                                f"--id={device.index or 0}"], capture_output=True, text=True,
                               timeout=30, check=True).stdout.strip()
        info["power_limit"] = limit
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = "not read"
    return info


def run(argv=None, device: str | None = None, benchmark: Path | None = None,
        bench_dir: Path = BENCH_DIR) -> dict:
    """One run; returns the result object. ``device`` other than None skips
    the look for a card; ``benchmark`` and ``bench_dir`` name another manifest
    and another tree of cell files (the harness's tests drive a run on the
    CPU so)."""
    args = parse_args(argv)
    from bench_h100.harness import guard, manifest

    offenders = guard.reference_offenders(bench_dir / "reference")
    if offenders:
        raise RunFailed(f"the reference imports the port or JAX: {offenders}")
    import torch

    cell = manifest.load_cell(benchmark or ROOT / "BENCHMARK.json", args.workload, bench_dir)
    if device is None:
        if not torch.cuda.is_available():
            raise RunFailed("no CUDA device: this benchmark runs on an NVIDIA GPU only")
        if torch.cuda.device_count() < cell.chips:
            raise RunFailed(f"{cell.name} needs {cell.chips} GPUs, "
                            f"{torch.cuda.device_count()} visible")
        device = "cuda"
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mode = cell.traffic["mode"]
    if mode not in ("eval", "train"):
        raise RunFailed(f"traffic mode {mode!r} has no runner")
    try:
        import modest_tpu_torch  # noqa: F401
    except ImportError as err:
        raise RunFailed(f"the program modest_tpu_torch is not importable here: {err}") from err
    from bench_h100.harness.context import TraceContext
    from bench_h100.harness.detector import EvalCell, percentile
    from bench_h100.harness.trainer import TrainCell

    runner = (EvalCell if mode == "eval" else TrainCell)(cell, args.seed, dev)
    runner.setup()
    setup_s = time.perf_counter() - STARTED
    traced = bool(args.trace)
    w = runner.window(args.seconds, traced=traced)
    device_info = {**card(torch, dev), "memory_peak_bytes": int(runner.memory_peak),
                   "matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
                   "cudnn_tf32": torch.backends.cudnn.allow_tf32}
    runner.release_port()
    if mode == "eval":
        reference, flops_per_batch = runner.reference_outputs(count_flops=traced)
        numbers = runner.numbers(runner.kept, reference)
    else:
        reference = runner.reference_readings(count_flops=traced)
        flops_per_batch = reference["flops"]
        numbers = runner.numbers(runner.port_readings(reference["b1"]), reference)
    limits = cell.limits["limits"]
    absent = sorted(set(limits) - set(numbers))
    if absent:
        raise RunFailed(f"{cell.name}: limits for numbers the comparison does not give: {absent}")
    checks = {name: {"value": numbers[name], "limit": limit} for name, limit in limits.items()}
    checks["failed_batches"] = {"value": w["failed"], "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    result = {"correct": correct, "attempted": w["batches"], "failed": w["failed"]}
    if traced:
        profile = w.get("profile")
        if profile is not None:
            profile["batches"] = runner.pool_size
        clock = w["clock"]
        def outside(values):  # the mean over the batches outside the profiled pass
            rest = [s for k, s in enumerate(values)
                    if not runner.pool_size <= k < 2 * runner.pool_size]
            return sum(rest) / len(rest)

        ctx = TraceContext(cell=cell, batch=runner.batch, batch_s=outside(w["latencies"]),
                           stage_ms={k: clock.mean_ms(k) for k in clock.batches[0]},
                           profile=profile, flops_per_batch=flops_per_batch,
                           data_wait_ms=1e3 * outside(w["waits"]) if "waits" in w else None)
        metrics = {}
        for m in cell.per_layer:
            value = manifest.metric_reader(m["name"], bench_dir).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        if profile is not None:
            device_info.update(busy_s=profile["busy_s"], window_s=profile["window_s"])
            result["breakdown"] = {"device_ops": profile["device_ops"],
                                   "idle_gaps": profile["idle_gaps"]}
    else:
        values = {"setup_s": setup_s}
        if mode == "eval":
            ms = [s * 1e3 for s in w["latencies"]]
            values.update(eval_scans_per_s=w["batches"] * runner.batch / w["seconds"],
                          eval_batch_ms_p90=percentile(ms, 90))
        else:
            values["train_scans_per_s"] = w["batches"] * runner.batch / w["seconds"]
        missing = [m["name"] for m in cell.end_to_end if m["name"] not in values]
        if missing:
            raise RunFailed(f"{cell.name}: no value for {missing}")
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result["metrics"] = metrics
    result["device"] = device_info
    result["checks"] = checks
    loaded = guard.forbidden_loaded()
    if loaded:
        raise RunFailed(f"modules of JAX or the JAX package were loaded: {loaded}")
    borrowed = guard.reference_modules_clean("bench_h100.reference")
    if borrowed:
        raise RunFailed(f"the reference holds objects of the port: {borrowed}")
    return result


def main(argv=None) -> int:
    try:
        with contextlib.redirect_stdout(sys.stderr):  # the result is standard out's one line
            result = run(argv)
    except RunFailed as err:
        print(f"bench_h100: {err}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
