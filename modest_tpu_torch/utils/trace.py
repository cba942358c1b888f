"""Spans and counters inside the port, for a traced run.

    from modest_tpu_torch.utils import trace

    trace.enable()
    with trace.span("nms"):
        trace.count("nms.blocks")
        ...
    counts = trace.disable()   # {"nms.blocks": 1}

Off by default. While off, ``span(name)`` returns one shared no-op context and
``count(name, n)`` returns at once, each after one test of a module
attribute: no allocation, no profiler range, no tensor touched, so the main
path pays nothing it can measure. While on and a ``torch.profiler`` session
records, each span is a ``modest:<name>`` range, so the device trace puts
kernels and idle time down to it on the profiler's own clock, and the
profiler's events carry its start, end, thread and nesting; with no
profiler recording a span does nothing. Counters are integers summed in
memory; ``disable()`` stops the tracer and returns them.

Neither a span nor a counter reads a tensor to the host: callers count only
what the host already knows (loop trips, values the code has already read).
This module imports torch only in ``enable()``, so the loader's spawned
workers, which import ``data/loader.py``, never load it.
"""
from __future__ import annotations

import contextlib
import threading

PREFIX = "modest:"  # the profiler range of a span; never ``stage:``, the benchmark's

_NOOP = contextlib.nullcontext()
_record: "_Record | None" = None  # the counters while on, else None


class _Record:
    def __init__(self):
        import torch

        self.counts: dict[str, int] = {}
        self.lock = threading.Lock()
        self.profiling = torch.autograd._profiler_enabled
        self.range = torch.profiler.record_function


def span(name: str):
    """A context that is the profiler range ``modest:<name>`` while the
    tracer is on and a profiler records."""
    rec = _record
    if rec is None or not rec.profiling():
        return _NOOP
    return rec.range(PREFIX + name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while the tracer is on."""
    rec = _record
    if rec is None:
        return
    with rec.lock:
        rec.counts[name] = rec.counts.get(name, 0) + n


def active() -> bool:
    """Whether the tracer is on: lets a caller skip work that only feeds a
    counter."""
    return _record is not None


def enable() -> None:
    """Start the tracer with every counter at zero."""
    global _record
    _record = _Record()


def disable() -> dict[str, int]:
    """Stop the tracer and return its counters (empty if it was off)."""
    global _record
    rec, _record = _record, None
    if rec is None:
        return {}
    with rec.lock:
        return dict(rec.counts)
