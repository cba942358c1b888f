"""Device time and idle time by program span, from a ``torch.profiler``
Chrome trace.

The port's tracer (``modest_tpu_torch/utils/trace.py``), while it is on and a
profiler records, opens a ``modest:<name>`` range for each of its spans
(``nms``, ``iou.overlap``, ``loader.epoch_start`` ...). ``reduce_spans``
reads those ranges beside the benchmark's own ``stage:`` ranges over the
profiled span:

* each kernel, copy and set inside the span is put down to the innermost
  ``modest:`` range open on the host thread that launched it (its
  ``cuda_runtime`` event, found by correlation id), else
  to the innermost ``stage:`` range open at the launch, else to ``host``;
* every idle interval of the device (outside the union of its operations,
  as ``trace.py::reduce_profile`` takes it) is split over its whole length
  by the innermost ``modest:`` range open across each part, else the
  ``stage:`` range, else ``host``.

``device_s`` and ``idle_s`` hold these self times by label, so the first
sums to the operations' summed time and the second to ``window_s −
busy_s``. ``device_s_under`` and ``idle_s_under`` hold, for each
``modest:`` range name, the time under it with its children (the device
time of ``nms`` with the ``iou.overlap`` launches inside it; the idle time
of ``loader.epoch_start`` with its ``loader.wait`` parts). ``ranges``
counts the ``modest:`` ranges that open inside the span, by name (the NMS's
host reads are its ``nms.host_read`` ranges).

No metric of ``run.py`` calls this yet: that needs the tracer turned on in
the cells' ``window()`` and a field of ``TraceContext`` for its result, which
a ``benchmark`` change brings with the per-layer metrics that read it.
Until then ``bench_h100/traced_run.py`` applies that wiring from outside
for a measurement.
"""
from __future__ import annotations

from .trace import DEVICE_CATS

SPAN, STAGE, HOST = "modest:", "stage:", "host"
_OPEN, _POINT, _CLOSE = 0, 1, 2  # at one instant: ranges open, then points, then close


def _correlation(e) -> int | None:
    c = (e.get("args") or {}).get("correlation")
    return None if c is None else int(c)


def label_ops(events: list[dict], span_us: tuple[float, float]):
    """The device operations inside ``span_us`` with their labels, and the
    idle parts with theirs.

    Returns ``(ops, idle, launched)``: ``ops`` a list of ``(name, seconds,
    label, under)`` (seconds clipped to the span; ``under`` the set of
    ``modest:`` names open around its launch on its thread), ``idle`` a list
    of ``(seconds, label, under)``, ``launched`` how many operations had a
    launch event."""
    lo, hi = span_us
    ops = []  # (start, end, name, correlation, unclipped start)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        start, dur = float(e["ts"]), float(e.get("dur", 0.0))
        a, b = max(start, lo), min(start + dur, hi)
        if b > a:
            ops.append((a, b, e.get("name", "?"), _correlation(e), start))
    launches = {}
    ranges = []  # (start, end, name, tid)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat == "cuda_runtime":
            c = _correlation(e)
            if c is not None:
                launches[c] = (float(e["ts"]), e.get("tid"))
        elif cat == "user_annotation":
            name = str(e.get("name", ""))
            if name.startswith((SPAN, STAGE)):
                ranges.append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                               name, e.get("tid")))

    # the device's idle intervals inside the span
    gaps, end = [], lo
    for a, b, *_ in sorted(ops, key=lambda o: o[0]):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))

    points = []
    for i, (a, b, _, _) in enumerate(ranges):
        points.append((a, _OPEN, i))
        points.append((b, _CLOSE, i))
    launched = 0
    for k, (_, _, _, corr, start) in enumerate(ops):
        at = launches.get(corr)
        launched += at is not None
        points.append((at[0] if at is not None else start, _POINT, ("op", k)))
    for a, b in gaps:
        points.append((a, _POINT, ("gap", True)))
        points.append((b, _POINT, ("gap", False)))
    points.sort(key=lambda p: (p[0], p[1]))

    anyone = object()  # a thread id no range has: ranges of every thread

    def mine(i, prefix, tid):
        return ranges[i][2].startswith(prefix) and (tid is anyone or ranges[i][3] == tid)

    def innermost(active, prefix, tid=anyone):
        inner = max((i for i in active if mine(i, prefix, tid)),
                    key=lambda i: (ranges[i][0], -ranges[i][1], i), default=None)
        return None if inner is None else ranges[inner][2]

    def under(active, tid=anyone):
        return frozenset(ranges[i][2] for i in active if mine(i, SPAN, tid))

    active: set[int] = set()
    labelled, idle = [None] * len(ops), []
    in_gap, prev = False, lo
    for t, kind, what in points:
        if in_gap and t > prev:
            lab = innermost(active, SPAN) or innermost(active, STAGE) or HOST
            idle.append(((t - prev) * 1e-6, lab, under(active)))
        prev = t
        if kind == _OPEN:
            active.add(what)
        elif kind == _CLOSE:
            active.discard(what)
        elif what[0] == "gap":
            in_gap = what[1]
        else:
            k = what[1]
            a, b, name, corr, _ = ops[k]
            if corr in launches:  # the spans of the thread that launched it
                tid = launches[corr][1]
                lab = innermost(active, SPAN, tid) or innermost(active, STAGE) or HOST
                names = under(active, tid)
            else:  # no launch event: the stage open at its start on the device
                lab, names = innermost(active, STAGE) or HOST, frozenset()
            labelled[k] = (name, (b - a) * 1e-6, lab, names)
    return labelled, idle, launched


def reduce_spans(events: list[dict], span_us: tuple[float, float]) -> dict:
    """Device and idle seconds by label and under each ``modest:`` range
    (the module's docstring says how), with the operations counted."""
    ops, idle, launched = label_ops(events, span_us)
    out = {"device_s": {}, "idle_s": {}, "device_s_under": {}, "idle_s_under": {},
           "ranges": {}, "ops": len(ops), "launched": launched}

    def add(table, key, s):
        table[key] = table.get(key, 0.0) + s

    for _, s, lab, names in ops:
        add(out["device_s"], lab, s)
        for n in names:
            add(out["device_s_under"], n, s)
    for s, lab, names in idle:
        add(out["idle_s"], lab, s)
        for n in names:
            add(out["idle_s_under"], n, s)
    lo, hi = span_us
    for e in events:
        name = str(e.get("name", ""))
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation" and name.startswith(SPAN)
                and lo <= float(e["ts"]) < hi):
            add(out["ranges"], name, 1)
    return out
