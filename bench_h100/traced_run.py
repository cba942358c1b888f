"""A traced benchmark run with the port's tracer on over the profiled pass,
and the span reduction of its trace (``harness/spans.py``): the wiring that
``harness/detector.py`` and ``harness/trainer.py`` would need, applied from
outside for a measurement. Not part of a benchmark run.

    PORT_TRACE=1 python bench_h100/traced_run.py --workload <cell> --seed <n> --seconds <s> --trace 1

``PORT_TRACE=0`` leaves the tracer off, for the tracer's cost on the same
seed. Prints one JSON summary line and writes the run's whole result, with
its ``extra`` object, to ``build/trace_bench/<cell>.<seed>.<on|off>.json``.
``extra`` holds the reduction (device and idle seconds by span), its check
against ``reduce_profile``'s sums, the tracer's counters, the int64 scan's
device time by span, the three longest idle gaps split by span, the mean
batch (or step) time inside and outside the profiled pass, and
``proposed_metrics``: the seven per-layer metrics a wired harness would
report, each read as its reader would read it.
"""
import json
import os
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

ON = os.environ.get("PORT_TRACE", "1") == "1"
got = {}


def _gaps(events, window, device_cats):
    """The device's idle intervals inside ``window``."""
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in events
                 if e.get("ph") == "X" and e.get("cat") in device_cats)
    gaps, end = [], window[0]
    for a, b in dev:
        a, b = max(a, window[0]), min(b, window[1])
        if b <= a:
            continue
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if window[1] > end:
        gaps.append((end, window[1]))
    return gaps


def install():
    """The wiring, applied in ``main`` and not at import: the loader's
    spawned workers import this file as their main module."""
    import torch

    from bench_h100.harness import spans
    from bench_h100.harness import trace as htrace
    from bench_h100.harness.detector import EvalCell
    from bench_h100.harness.trainer import TrainCell
    from modest_tpu_torch.utils import trace as port_trace

    class Profile(torch.profiler.profile):  # the traced branch of window()
        def __enter__(self):
            out = super().__enter__()
            if ON:
                port_trace.enable()
            return out

    torch.profiler.profile = Profile
    export_events = htrace.export_events

    def export(prof):
        got["counts"] = port_trace.disable()
        events = export_events(prof)
        window = htrace.span_of(events, "bench:profiled")
        red = got["reduced"] = spans.reduce_spans(events, window)
        prof_r = htrace.reduce_profile(events, window)
        got["check"] = {"device_sum_s": sum(red["device_s"].values()),
                        "by_name_sum_s": sum(prof_r["by_name"].values()),
                        "idle_sum_s": sum(red["idle_s"].values()),
                        "window_minus_busy_s": prof_r["window_s"] - prof_r["busy_s"]}
        scan = {}
        for name, s, lab, under in spans.label_ops(events, window)[0]:
            if "scan_innermost_dim" in name and "long" in name:
                scan[lab] = scan.get(lab, 0.0) + s
                key = "under_nms" if "modest:nms" in under else "outside_nms"
                scan[key] = scan.get(key, 0.0) + s
        got["int64_scan_by_label_s"] = scan
        longest = sorted(_gaps(events, window, htrace.DEVICE_CATS), key=lambda g: g[0] - g[1])[:3]
        got["longest_gaps"] = [
            {"ms": (b - a) * 1e-3,
             "split_ms": {k: v * 1e3 for k, v in spans.reduce_spans(events, (a, b))["idle_s"].items()}}
            for a, b in longest]
        return events

    htrace.export_events = export
    for cls, mode in ((EvalCell, "eval"), (TrainCell, "train")):
        def window(self, seconds, traced=False, _orig=cls.window, _mode=mode):
            got["w"] = _orig(self, seconds, traced)
            got["pool"], got["mode"] = self.pool_size, _mode
            return got["w"]
        cls.window = window


def proposed(mode: str, red: dict, counts: dict, pool: int) -> dict:
    """The seven per-layer metrics, a batch (eval) or a step (train)."""
    du, iu = red["device_s_under"], red["idle_s_under"]
    out = {f"{mode}.nms_idle_ms": 1e3 * iu.get("modest:nms", 0.0) / pool}
    if mode == "eval":
        out["eval.nms_device_ms"] = 1e3 * du.get("modest:nms", 0.0) / pool
        out["eval.nms_host_reads"] = red["ranges"].get("modest:nms.host_read", 0) / pool
        out["eval.iou_device_ms"] = 1e3 * du.get("modest:iou.overlap", 0.0) / pool
    else:
        out["train.loader_restart_ms"] = 1e3 * iu.get("modest:loader.epoch_start", 0.0) / pool
        if counts.get("loader.asks"):
            out["train.loader_ready"] = counts.get("loader.ready", 0) / counts["loader.asks"]
    return out


def main():
    from bench_h100 import run as bench_run

    install()
    argv = sys.argv[1:]
    args = bench_run.parse_args(argv)
    rehearse = {}  # a CPU rehearsal on a tiny cell: another device, manifest and tree
    if os.environ.get("REHEARSE_TREE"):
        tree = Path(os.environ["REHEARSE_TREE"])
        rehearse = {"device": "cpu", "benchmark": tree.parent / "BENCHMARK.json",
                    "bench_dir": tree}
    result = bench_run.run(argv, **rehearse)
    lat, pool = got["w"]["latencies"], got["pool"]
    outside = [s for k, s in enumerate(lat) if not pool <= k < 2 * pool]
    extra = {"port_trace": ON, "batches": pool, "batches_run": len(lat),
             "batch_ms_outside": 1e3 * statistics.mean(outside),
             "batch_ms_profiled": 1e3 * statistics.mean(lat[pool:2 * pool])}
    if "reduced" in got:
        extra.update({k: got[k] for k in ("check", "reduced", "counts", "int64_scan_by_label_s",
                                          "longest_gaps")})
        extra["proposed_metrics"] = proposed(got["mode"], got["reduced"], got["counts"], pool) if ON else {}
    result["extra"] = extra
    tag = f"{args.workload}.{args.seed}.{'on' if ON else 'off'}"
    out = ROOT / "build" / "trace_bench"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{tag}.json").write_text(json.dumps(result))
    summary = {"tag": tag, "correct": result["correct"],
               "metrics": {k: v["value"] for k, v in result["metrics"].items()},
               "device": {k: result["device"].get(k) for k in ("kind", "power_limit", "busy_s",
                                                                "window_s")},
               **{k: extra.get(k) for k in ("batch_ms_outside", "batch_ms_profiled", "check",
                                            "counts", "proposed_metrics",
                                            "int64_scan_by_label_s", "longest_gaps")}}
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
