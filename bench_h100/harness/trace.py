"""Stage spans by CUDA events, and the device's busy time from
``torch.profiler``.

``StageClock`` is the ``on_stage`` callback the port's detectors take: it
records a CUDA event at each stage boundary and opens a profiler range named
after the stage that follows, so the trace can say what the host was doing
in each idle gap. ``reduce_profile`` reads the exported Chrome trace: every
kernel, copy and set on the device, their union over the profiled span
(busy time, as ``tools/profile_eval.py`` takes the busy share), the device
operations that took most time, and the longest idle gaps with the host
range open at their start.
"""
from __future__ import annotations

import json
import os
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class StageClock:
    """Per-batch stage times (ms) from CUDA events: ``begin()`` before the
    forward, the instance as ``on_stage`` and for the harness's own stages,
    ``end()`` once the batch's results are on the host."""

    def __init__(self, first_stage: str, next_stage: dict, ranges: bool = False):
        self.first, self.next_stage, self.ranges = first_stage, next_stage, ranges
        self.events: list = []
        self.batches: list[dict[str, float]] = []
        self._range = None

    def _open(self, name):
        if self.ranges:
            self._range = torch.profiler.record_function(f"stage:{name}")
            self._range.__enter__()

    def _close(self):
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None

    def _record(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append((name, ev))

    def begin(self):
        self.events = []
        self._record("start")
        self._open(self.first)

    def __call__(self, name):
        self._record(name)
        self._close()
        self._open(self.next_stage.get(name, "host"))

    def end(self):
        self._close()
        row = {}
        for (_, a), (name, b) in zip(self.events, self.events[1:]):
            row[name] = row.get(name, 0.0) + a.elapsed_time(b)
        self.batches.append(row)

    def mean_ms(self, *names) -> float | None:
        if not self.batches or any(n not in self.batches[0] for n in names):
            return None
        return sum(sum(row[n] for n in names) for row in self.batches) / len(self.batches)


def export_events(prof) -> list[dict]:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    return data["traceEvents"] if isinstance(data, dict) else data


def reduce_profile(events: list[dict], span_us: tuple[float, float]) -> dict:
    """Busy seconds, device time by operation and the longest idle gaps of
    the device operations inside ``span_us`` (profiler clock, µs)."""
    lo, hi = span_us
    ops = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        start, dur = float(e["ts"]), float(e.get("dur", 0.0))
        a, b = max(start, lo), min(start + dur, hi)
        if b > a:
            ops.append((a, b, e.get("name", "?")))
    ops.sort()
    busy, gaps, end = 0.0, [], lo
    by_name: dict[str, float] = {}
    for a, b, name in ops:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if hi > end:
        gaps.append((end, hi))
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                    for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and str(e.get("name", "")).startswith("stage:"))

    def host_at(t):
        label = "host"
        for a, b, name in ranges:
            if a > t:
                break
            if b >= t:
                label = name[len("stage:"):]
        return label

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {"busy_s": busy * 1e-6, "window_s": (hi - lo) * 1e-6, "ops": len(ops),
            "device_ops": sorted(([n, s] for n, s in by_name.items()), key=lambda x: -x[1])[:10],
            "by_name": by_name,
            "idle_gaps": [[host_at(a), (b - a) * 1e-6] for a, b in longest]}


def span_of(events: list[dict], marker: str) -> tuple[float, float]:
    """The profiler-clock span of the user range named ``marker``."""
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e.get("name") == marker:
            return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
    raise ValueError(f"the trace has no range {marker!r}")
