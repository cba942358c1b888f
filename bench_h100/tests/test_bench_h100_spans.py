"""Device time and idle time by program span (``harness/spans.py``) on
hand-built Chrome traces, and ``harness/trace.py::reduce_profile`` unchanged
by the port's ``modest:`` ranges."""
from __future__ import annotations

import pytest

from bench_h100.harness import spans, trace


def rng(name, a, b, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": a, "dur": b - a,
            "tid": tid}


def launch(corr, at, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": at, "dur": 2,
            "tid": tid, "args": {"correlation": corr}}


def op(name, a, b, corr=None, cat="kernel"):
    e = {"ph": "X", "cat": cat, "name": name, "ts": a, "dur": b - a, "tid": 7}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def eval_trace():
    """A post-processing stage with an NMS in it: an overlap inside the NMS,
    a host read, a launch from another thread and a copy with no launch."""
    return [
        rng("bench:profiled", 0, 1000),
        rng("stage:backbone", 0, 400), rng("stage:post_process", 400, 1000),
        rng("modest:nms", 450, 900), rng("modest:iou.overlap", 460, 480),
        rng("modest:nms.host_read", 600, 700),
        launch(1, 100), op("gemm", 110, 200, 1),
        launch(2, 465), op("scan", 470, 520, 2),
        launch(3, 550), op("scan", 550, 600, 3),
        launch(4, 455, tid=2), op("reduce", 700, 750, 4),
        op("Memcpy HtoD", 950, 960, cat="gpu_memcpy"),
    ]


def test_each_kernel_goes_to_the_innermost_span_open_at_its_launch():
    got = spans.reduce_spans(eval_trace(), (0, 1000))
    us = {k: round(v * 1e6, 6) for k, v in got["device_s"].items()}
    assert us == {"stage:backbone": 90, "modest:iou.overlap": 50, "modest:nms": 50,
                  "stage:post_process": 60}
    under = {k: round(v * 1e6, 6) for k, v in got["device_s_under"].items()}
    assert under == {"modest:nms": 100, "modest:iou.overlap": 50}
    assert got["ops"] == 5 and got["launched"] == 4
    assert got["ranges"] == {"modest:nms": 1, "modest:iou.overlap": 1, "modest:nms.host_read": 1}


def test_idle_time_is_split_over_its_length_by_the_innermost_span():
    events = eval_trace()
    got = spans.reduce_spans(events, (0, 1000))
    us = {k: round(v * 1e6, 6) for k, v in got["idle_s"].items()}
    assert us == {"stage:backbone": 310, "stage:post_process": 140, "modest:nms": 190,
                  "modest:iou.overlap": 10, "modest:nms.host_read": 100}
    under = {k: round(v * 1e6, 6) for k, v in got["idle_s_under"].items()}
    assert under == {"modest:nms": 300, "modest:iou.overlap": 10, "modest:nms.host_read": 100}
    prof = trace.reduce_profile(events, (0, 1000))
    assert sum(got["idle_s"].values()) == pytest.approx(prof["window_s"] - prof["busy_s"])
    assert sum(got["device_s"].values()) == pytest.approx(sum(prof["by_name"].values()))


def test_an_idle_interval_across_the_epoch_start_and_a_stage_is_split_by_length():
    events = [
        rng("bench:profiled", 0, 300),
        rng("modest:loader.epoch_start", 0, 100), rng("modest:loader.wait", 10, 90),
        rng("stage:backbone", 100, 300),
        launch(1, 150), op("conv", 200, 250, 1),
    ]
    got = spans.reduce_spans(events, (0, 300))
    us = {k: round(v * 1e6, 6) for k, v in got["idle_s"].items()}
    assert us == {"modest:loader.epoch_start": 20, "modest:loader.wait": 80,
                  "stage:backbone": 150}
    assert got["idle_s_under"]["modest:loader.epoch_start"] == pytest.approx(100e-6)
    assert got["device_s"] == {"stage:backbone": pytest.approx(50e-6)}


def test_reduce_profile_reads_the_same_with_and_without_modest_ranges():
    with_spans = eval_trace()
    without = [e for e in with_spans if not str(e.get("name", "")).startswith("modest:")]
    assert trace.reduce_profile(with_spans, (0, 1000)) == trace.reduce_profile(without, (0, 1000))
    assert trace.reduce_profile(without, (0, 1000))["idle_gaps"][0][0] == "backbone"


def test_a_profiler_trace_of_the_ports_spans_reduces_on_the_cpu():
    """The exported trace's own format: ranges of the tracer on the CPU, no
    device operation, so the whole span is idle and split by the ranges."""
    import torch

    from modest_tpu_torch.utils import trace as port_trace

    port_trace.enable()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with torch.profiler.record_function("bench:profiled"):
                with torch.profiler.record_function("stage:post_process"):
                    with port_trace.span("nms"):
                        torch.ones(1000).cumsum(0)
    finally:
        port_trace.disable()
    events = trace.export_events(prof)
    window = trace.span_of(events, "bench:profiled")
    got = spans.reduce_spans(events, window)
    assert got["ops"] == 0 and got["device_s"] == {}
    assert got["ranges"] == {"modest:nms": 1}
    assert got["idle_s"]["modest:nms"] > 0
    assert got["idle_s_under"]["modest:nms"] == pytest.approx(got["idle_s"]["modest:nms"])
    assert sum(got["idle_s"].values()) == pytest.approx((window[1] - window[0]) * 1e-6)
