"""The port's tracer (``modest_tpu_torch/utils/trace.py``): nothing recorded
and no profiler range while off; counters, and spans as nested ``modest:``
ranges under ``torch.profiler``, while on; the NMS's and the loader's
spans and counters against the loops' own trips; ``profile_eval``'s
reading of the loader's; and PV-RCNN's ball-query, grouping and BEV spans
and counters over a tiny eval forward (the config of
``tests/test_torch_pv_rcnn.py``)."""
import numpy as np
import pytest
import torch

from modest_tpu_torch.data import loader as tloader
from modest_tpu_torch.models import build_network
from modest_tpu_torch.ops import iou3d
from modest_tpu_torch.tools import profile_eval
from modest_tpu_torch.utils import trace
from modest_tpu_torch.utils.config import Config
from tests.test_torch_grid_detectors import geometry, toy_batch
from tests.test_torch_pv_rcnn import GT_XY, MAX_VOXELS, pvrcnn_model_cfg
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    yield
    trace.disable()


CPU = [torch.profiler.ProfilerActivity.CPU]


def modest_events(prof) -> list:
    """The tracer's ranges in a profile, in the order they opened."""
    return sorted((e for e in prof.events() if e.name.startswith(trace.PREFIX)),
                  key=lambda e: e.time_range.start)


def parent_span(e):
    """The name of the innermost ``modest:`` range around a profiler event."""
    p = e.cpu_parent
    while p is not None and not p.name.startswith(trace.PREFIX):
        p = p.cpu_parent
    return None if p is None else p.name[len(trace.PREFIX):]


def test_off_enters_no_profiler_range_and_records_nothing(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered while the tracer is off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert trace.span("a") is trace.span("b")  # one shared no-op context
    with torch.profiler.profile(activities=CPU):
        with trace.span("nms"):
            trace.count("nms.blocks")
    boxes = torch.tensor([[[0.0, 0, 0, 2, 1, 1, 0], [0.1, 0, 0, 2, 1, 1, 0]]])
    iou3d.nms_bev(boxes, torch.tensor([[0.9, 0.8]]), 0.5, 2)
    assert not trace.active()
    assert trace.disable() == {}


def test_on_keeps_parents_and_disable_returns_and_clears():
    trace.enable()
    assert trace.active()
    assert trace.span("a") is trace.span("b")  # no profiler records: no range
    with torch.profiler.profile(activities=CPU) as prof:
        with trace.span("outer"):
            with trace.span("inner"):
                trace.count("c", 2)
            with trace.span("second"):
                trace.count("c")
        with trace.span("after"):
            pass
    assert trace.disable() == {"c": 3}
    events = modest_events(prof)
    assert [e.name[len(trace.PREFIX):] for e in events] == ["outer", "inner", "second", "after"]
    assert [parent_span(e) for e in events] == [None, "outer", "outer", None]
    outer, inner = events[0].time_range, events[1].time_range
    assert outer.start <= inner.start and inner.end <= outer.end
    assert not trace.active()
    assert trace.disable() == {}
    with trace.span("unrecorded"):
        trace.count("c")
    trace.enable()
    assert trace.disable() == {}


def test_on_under_the_profiler_each_span_is_a_modest_range():
    trace.enable()
    with torch.profiler.profile(activities=CPU) as prof:
        with trace.span("nms"):
            with trace.span("iou.overlap"):
                torch.ones(3).sum()
    trace.disable()
    names = {e.name for e in prof.events()}
    assert {"modest:nms", "modest:iou.overlap"} <= names
    assert not any(n.startswith("stage:") for n in names)


def _boxes(centres):
    """Unit-height 2 × 1 boxes at the given BEV centres, scores descending."""
    b = torch.zeros(1, len(centres), 7, dtype=torch.float64)
    b[0, :, 0] = torch.tensor([c[0] for c in centres], dtype=torch.float64)
    b[0, :, 1] = torch.tensor([c[1] for c in centres], dtype=torch.float64)
    b[0, :, 3:6] = torch.tensor([2.0, 1.0, 1.0], dtype=torch.float64)
    scores = torch.linspace(1.0, 0.5, len(centres), dtype=torch.float64)[None]
    return b, scores


CASES = {
    # 600 boxes 10 m apart: 3 blocks, no suppression, one round each
    "apart": (_boxes([(10.0 * i, 0.0) for i in range(600)]), 0.1, 600),
    # a chain inside one block, each box over its neighbour: keep 0 and 2
    # after three Jacobi rounds
    "chain": (_boxes([(0.0, 0.0), (1.2, 0.0), (2.4, 0.0)]), 0.1, 3),
    # 300 boxes apart and one slot: the first block fills it, and the second
    # block's test ends the loop without a block
    "full": (_boxes([(10.0 * i, 0.0) for i in range(300)]), 0.1, 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_nms_counters_equal_the_loops_trips_and_the_keep_set_is_unchanged(monkeypatch, case):
    (boxes, scores), thresh, max_keep = CASES[case]
    want_idx, want_mask = iou3d.nms_bev(boxes, scores, thresh, max_keep)
    trips = {"iou": 0, "equal": 0}
    iou_bev, equal = iou3d.boxes_iou_bev, torch.equal

    def counted_iou(*args):
        trips["iou"] += 1
        return iou_bev(*args)

    def counted_equal(*args):
        trips["equal"] += 1
        return equal(*args)

    monkeypatch.setattr(iou3d, "boxes_iou_bev", counted_iou)
    monkeypatch.setattr(torch, "equal", counted_equal)
    trace.enable()
    with torch.profiler.profile(activities=CPU) as prof:
        idx, mask = iou3d.nms_bev(boxes, scores, thresh, max_keep)
    counts = trace.disable()
    monkeypatch.undo()
    assert torch.equal(idx, want_idx) and torch.equal(mask, want_mask)
    blocks = trips["iou"] // 2  # each block: kept × block and block × block
    early_stop = int(case == "full")
    assert counts["nms.blocks"] == blocks
    assert counts["nms.rounds"] == trips["equal"]
    want = {"apart": (3, 3), "chain": (1, 3), "full": (1, 1)}[case]
    assert (counts["nms.blocks"], counts["nms.rounds"]) == want
    if case == "chain":
        assert idx[0][mask[0]].tolist() == [0, 2]
    events = modest_events(prof)
    names = [e.name[len(trace.PREFIX):] for e in events]
    assert names[0] == "nms" and names.count("nms") == 1
    # one host read per block test and per round
    assert names.count("nms.host_read") == blocks + trips["equal"] + early_stop
    assert names.count("iou.overlap") == trips["iou"]
    assert all(parent_span(e) == "nms" for e in events[1:])


def _scans(n=10):
    """Tiny scans as a list, which the spawned workers unpickle without
    importing this module."""
    return [{"frame_id": f"{i:06d}", "points": np.full((4, 4), i, np.float32),
             "gt_boxes": np.full((1, 8), i, np.float32)} for i in range(n)]


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_asks_equal_its_batches_over_an_epoch(workers):
    loader = tloader.DataLoader(_scans(), 3, shuffle=True, num_workers=workers,
                                use_procs=workers > 0)
    try:
        trace.enable()
        with torch.profiler.profile(activities=CPU) as prof:
            batches = list(tloader.prefetch_to_device(loader, "cpu"))
        counts = trace.disable()
    finally:
        loader.close()
    assert len(batches) == len(loader) == 3
    assert counts["loader.asks"] == len(loader)
    events = modest_events(prof)
    names = [e.name[len(trace.PREFIX):] for e in events]
    assert names.count("loader.epoch_start") == 1
    assert names.count("loader.to_device") == len(loader)
    if workers:
        assert names.count("loader.wait") == len(loader)
        assert 0 <= counts.get("loader.ready", 0) <= len(loader) * 2 * workers
    else:
        assert "loader.wait" not in names and "loader.ready" not in counts
    # the epoch's start holds its first two requests and the first batch's copy
    start = events[names.index("loader.epoch_start")].time_range
    inside = [e for e in events if e.name == "modest:loader.to_device"
              and e.time_range.start <= start.end]
    assert len(inside) == 1


@pytest.mark.parametrize("workers", [0, 2])
def test_profile_eval_reads_the_loaders_spans_and_counters(tmp_path, workers):
    got = profile_eval.profile_loader(tmp_path, 2, workers, "cpu", scans=4, full_density=False)
    per_epoch = 2  # 4 scans in batches of 2
    spans, counts = got["spans"], got["counters"]
    assert spans["loader.epoch_start"]["count"] == 2
    assert spans["loader.epoch_start"]["host_ms"] > 0
    assert spans["loader.to_device"]["count"] == 2 * per_epoch
    assert counts["loader.asks"] == 2 * per_epoch
    if workers:
        assert spans["loader.wait"]["count"] == 2 * per_epoch
        assert 0 <= got["ready_per_ask"] <= 2 * workers
    else:
        assert "loader.wait" not in spans and got["ready_per_ask"] == 0


@pytest.fixture(scope="module")
def tiny_pvrcnn():
    """The tiny PV-RCNN in eval mode on the CPU, and a batch of two scans."""
    model = build_network(Config(pvrcnn_model_cfg()), 1, device="cpu", dataset=geometry("second"))
    pts, _ = toy_batch(0, GT_XY)
    return model.eval(), torch.from_numpy(pts)


def staged_forward(model, points):
    """The eval forward with each of ``model.stages`` a ``stage:`` profiler
    range, as the benchmark's stage clock opens them."""
    order = list(model.stages)
    current = [torch.profiler.record_function("stage:" + order[0])]
    current[0].__enter__()

    def mark(name):
        current[0].__exit__(None, None, None)
        following = order[order.index(name) + 1] if name != order[-1] else "host"
        current[0] = torch.profiler.record_function("stage:" + following)
        current[0].__enter__()

    with torch.inference_mode():
        out = model(points, on_stage=mark, max_voxels=MAX_VOXELS)
    current[0].__exit__(None, None, None)
    return out


def test_ball_query_counters_sum_the_distances_of_a_vsa_forward(tiny_pvrcnn):
    model, points = tiny_pvrcnn
    sources = {f"vsa.{k}": m for k, m in model.vsa.items()}
    sources["roi_grid_pool"] = model.roi_grid_pool
    pairs, centres, calls = [0], [0], []

    def seen(module, args):  # xyz (B, N, 3), ..., centres (B, M, 3); a ball query a radius
        (b, n, _), m = args[0].shape, args[3].shape[1]
        pairs[0] += len(module.radii) * b * m * n
        centres[0] += len(module.radii) * b * m
        calls.append(module)

    hooks = [m.register_forward_pre_hook(seen) for m in sources.values()]
    trace.enable()
    with torch.inference_mode():
        model(points, max_voxels=MAX_VOXELS)
    counts = trace.disable()
    for hook in hooks:
        hook.remove()
    assert len(calls) == len(sources)
    assert counts["ball_query.pairs"] == pairs[0]
    assert counts["ball_query.centres"] == centres[0]
    assert not any(k.startswith("vsa.") for k in counts)  # no empty-ball count: a host read


def test_ball_query_and_group_are_siblings_inside_each_vsa_stage(tiny_pvrcnn):
    model, points = tiny_pvrcnn
    trace.enable()
    with torch.profiler.profile(activities=CPU) as prof:
        staged_forward(model, points)
    trace.disable()
    stages = {e.name[len("stage:"):]: e.time_range for e in prof.events()
              if e.name.startswith("stage:")}
    point_ops = {"modest:ball_query", "modest:group", "modest:vsa.bev"}
    spans = [e for e in modest_events(prof) if e.name in point_ops]
    assert {e.name for e in spans} == point_ops
    assert all(parent_span(e) is None for e in spans)  # none inside another
    for name in model.model_cfg.PFE.FEATURES_SOURCE:
        stage = stages[f"vsa_{name}"]
        inside = [e for e in spans
                  if stage.start <= e.time_range.start and e.time_range.end <= stage.end]
        names = [e.name[len(trace.PREFIX):] for e in inside]
        if name == "bev":
            assert names == ["vsa.bev"]
            continue
        radii = len(model.vsa[name].radii)
        assert names == ["ball_query", "group"] * radii
        for query, group in zip(inside[::2], inside[1::2]):
            assert query.time_range.end <= group.time_range.start
    grid = stages["grid_pool"]
    names = [e.name[len(trace.PREFIX):] for e in spans
             if grid.start <= e.time_range.start and e.time_range.end <= grid.end]
    assert names == ["ball_query", "group"] * len(model.roi_grid_pool.radii)


def test_pvrcnn_outputs_are_bit_identical_with_the_tracer_off_and_on(tiny_pvrcnn):
    model, points = tiny_pvrcnn
    with torch.inference_mode():
        off = model(points, max_voxels=MAX_VOXELS)
    assert trace.disable() == {}  # off: no counter kept
    trace.enable()
    with torch.profiler.profile(activities=CPU):
        on = staged_forward(model, points)
    assert trace.disable()["ball_query.pairs"] > 0
    assert off.keys() == on.keys()
    for key, value in off.items():
        assert torch.equal(value, on[key]), key
