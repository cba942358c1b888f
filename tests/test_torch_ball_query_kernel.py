"""The masked ball-query kernel (modest_tpu_torch/csrc/ball_query.cu) and its
dispatch.

On the CPU: ``ball_query_masked`` sends CPU tensors to the plain twin and
never reaches the kernel's wrapper; ``ball_query_cuda`` refuses a wrong
device, dtype, shape, a non-contiguous input, an nsample past 64 or an r²
at ``BIG`` or above before it builds or launches anything, as does the cross
check ``ball_query_cross_cuda``; a launch, made with the tensors' device
current, hands the kernel r² as the float32 of the host's double radius *
radius and counts itself, on the wrapper and in the tracer's
``ball_query.kernel``; the plain twin keeps its rules
(strict d² < r², masked sources out, first hits by index, the first hit
repeated, an empty ball at index 0, the wrap-fill past N).

On the card (marker ``chip``; skipped where no CUDA device is visible): the
kernel's (idx, empty) equal the plain twin's bit for bit at the 12 ball
queries of the benchmark's PV-RCNN cell (the port's eval forward on four
scans like its pool, recorded call by call), at Waymo's raw-point shape
(2, 2048, 131072), on shells whose plain d² lies one ulp either side of r²
and on shells far from the origin where rounding decides about every pair,
with all-masked rows, empty balls, N < nsample and nsample 16, 32 and 64;
at the cell's and Waymo's shapes the kernel's cross term
(``ball_query_cross_cuda``) equals ``torch.matmul``'s, so a change of
cuBLAS's order is told apart from a fault of the kernel.
Run them there with ``python -m pytest tests/test_torch_ball_query_kernel.py
-m chip --noconftest``: ``tests/conftest.py`` imports JAX, which the card's
machine lacks, and this module does not import it.
"""
import numpy as np
import pytest
import torch

from modest_tpu_torch.ops import pointnet2_stack as stack
from modest_tpu_torch.tools import ball_query_cases as cases
from modest_tpu_torch.tools.scenes import bench_scans
from modest_tpu_torch.utils import trace
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


def _inputs(b=2, n=40, m=5, seed=0, device="cpu"):
    rng = np.random.RandomState(seed)
    xyz = torch.as_tensor(rng.uniform(-1, 1, (b, n, 3)), dtype=torch.float32, device=device)
    mask = torch.as_tensor(rng.uniform(size=(b, n)) > 0.2, device=device)
    new_xyz = torch.as_tensor(rng.uniform(-1, 1, (b, m, 3)), dtype=torch.float32, device=device)
    return xyz, mask, new_xyz


def test_cpu_tensors_take_the_plain_twin(monkeypatch):
    def refuse(*args):
        raise AssertionError("a CPU tensor reached the kernel's wrapper")

    monkeypatch.setattr(stack, "ball_query_cuda", refuse)
    xyz, mask, new_xyz = _inputs()
    idx, empty = stack.ball_query_masked(xyz, mask, new_xyz, 0.5, 8)
    want_idx, want_empty = stack.ball_query_masked_plain(xyz, mask, new_xyz, 0.5, 8)
    assert torch.equal(idx, want_idx) and torch.equal(empty, want_empty)
    assert idx.shape == (2, 5, 8) and idx.dtype == torch.int64 and empty.dtype == torch.bool
    # the grouping's entry takes the same path
    feats = torch.zeros(2, 40, 4)
    grouped, flags = stack.query_and_group_masked(xyz, mask, feats, new_xyz, 0.5, 8)
    assert grouped.shape == (2, 5, 8, 7) and torch.equal(flags, want_empty)


def test_plain_twin_rules():
    """Strict d² < r², masked sources never in a ball, the first nsample
    hits by index, the first hit repeated, an empty ball at index 0, and
    past N the wrap-fill: slot s takes hit s % N, else the first hit."""
    xyz = torch.tensor([[[0.0, 0, 0], [0.5, 0, 0], [0.25, 0, 0], [0.1, 0, 0], [0.2, 0, 0]]])
    mask = torch.tensor([[True, True, True, False, True]])
    centres = torch.tensor([[[0.0, 0, 0], [5.0, 0, 0]]])
    idx, empty = stack.ball_query_masked_plain(xyz, mask, centres, 0.5, 4)
    assert idx.tolist() == [[[0, 2, 4, 0], [0, 0, 0, 0]]]  # 1 sits on the sphere, 3 is masked
    assert empty.tolist() == [[False, True]]
    idx, _ = stack.ball_query_masked_plain(xyz, mask, centres, 0.5, 2)
    assert idx.tolist() == [[[0, 2], [0, 0]]]
    idx, _ = stack.ball_query_masked_plain(xyz, mask, centres, 0.5, 12)
    assert idx[0, 0].tolist() == [0, 2, 4, 0, 0, 0, 2, 4, 0, 0, 0, 2]


@pytest.mark.parametrize("change,match", [
    ({}, "CUDA tensors"),
    ({"xyz": lambda x: x.double()}, "float32 xyz"),
    ({"new_xyz": lambda x: x.half()}, "float32 new_xyz"),
    ({"mask": lambda x: x.to(torch.uint8)}, "bool xyz_mask"),
    ({"xyz": lambda x: x[..., :2]}, r"\(B, rows, 3\) xyz"),
    ({"new_xyz": lambda x: x[0]}, r"\(B, rows, 3\) new_xyz"),
    ({"mask": lambda x: x[:, :-1]}, "disagree"),
    ({"new_xyz": lambda x: x[:1]}, "disagree"),
    ({"xyz": lambda x: x[:, :0], "mask": lambda x: x[:, :0]}, "N >= 1"),
    ({"nsample": 65}, "nsample <= 64"),
    ({"nsample": 0}, "nsample <= 64"),
    ({"xyz": lambda x: x.transpose(0, 1).contiguous().transpose(0, 1)}, "contiguous xyz"),
    ({"new_xyz": lambda x: torch.cat([x, x], -1)[..., ::2]}, "contiguous new_xyz"),
    ({"mask": lambda x: x.t().contiguous().t()}, "contiguous xyz_mask"),
    ({"radius": 31623.0}, "radius² below 1e"),  # r² = 1.00001e9: a masked source in the ball
], ids=["cpu", "float64", "float16", "uint8_mask", "two_coords", "no_batch", "mask_rows",
        "batch_mismatch", "no_source", "nsample_65", "nsample_0", "xyz_strided",
        "centres_strided", "mask_strided", "radius_past_big"])
def test_cuda_wrapper_refuses_without_building_or_launching(monkeypatch, change, match):
    def no_build():
        raise AssertionError("the wrapper built the kernel for an input it refuses")

    monkeypatch.setattr(stack, "_lib", no_build)
    xyz, mask, new_xyz = _inputs()
    args = {"xyz": xyz, "mask": mask, "new_xyz": new_xyz}
    for key, fn in change.items():
        if key not in ("nsample", "radius"):
            args[key] = fn(args[key])
    before = stack.ball_query_cuda.launches
    with pytest.raises(ValueError, match=match):
        stack.ball_query_cuda(args["xyz"], args["mask"], args["new_xyz"],
                              change.get("radius", 0.5), change.get("nsample", 16))
    assert stack.ball_query_cuda.launches == before


def test_cross_check_refuses_without_building(monkeypatch):
    def no_build():
        raise AssertionError("the cross check built the kernel for an input it refuses")

    monkeypatch.setattr(stack, "_lib", no_build)
    xyz, _, new_xyz = _inputs()
    for args, match in (((xyz, new_xyz), "CUDA tensors"),
                        ((xyz.double(), new_xyz), "float32 xyz"),
                        ((xyz, new_xyz[:1]), "disagree")):
        with pytest.raises(ValueError, match=match):
            stack.ball_query_cross_cuda(*args)


class _FakeLib:
    """Stands for the built library: records each launch's arguments and
    the device that was current at it."""

    def __init__(self, current):
        self.calls, self.current = [], current

    def ball_query_launch(self, *args):
        self.calls.append((args, self.current[-1] if self.current else None))
        return 0


class _FakeStream:
    cuda_stream = 7


def test_launch_passes_float32_r2_and_counts(monkeypatch):
    """With the device checks and the library stood in for, a launch gets
    the shapes, nsample and r² = float32(radius * radius) from the host's
    double and the current stream, is made while the tensors' device is
    current, and counts one launch on the wrapper and in the tracer."""
    import contextlib

    current = []

    @contextlib.contextmanager
    def on_device(device):
        current.append(device)
        try:
            yield
        finally:
            current.pop()

    lib = _FakeLib(current)
    monkeypatch.setattr(stack, "_lib", lambda: lib)
    monkeypatch.setattr(stack, "check_cuda", lambda where, tensors: None)
    monkeypatch.setattr(torch.cuda, "device", on_device)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: _FakeStream)
    xyz, mask, new_xyz = _inputs(b=3, n=40, m=5)
    radius = 0.8  # 0.8 * 0.8 = 0.6400000000000001 in double, 0.64 in float32
    before = stack.ball_query_cuda.launches
    trace.enable()
    try:
        idx, empty = stack.ball_query_cuda(xyz, mask, new_xyz, radius, 32)
        stack.ball_query_cuda(xyz, mask, new_xyz[:, :0], radius, 32)  # no centre: no launch
    finally:
        counts = trace.disable()
    assert stack.ball_query_cuda.launches == before + 1
    assert counts.get("ball_query.kernel") == 1
    assert idx.shape == (3, 5, 32) and idx.dtype == torch.int64
    assert empty.shape == (3, 5) and empty.dtype == torch.bool
    ((call, device),) = lib.calls
    assert device == xyz.device
    assert call[:3] == (xyz.data_ptr(), mask.data_ptr(), new_xyz.data_ptr())
    assert call[3:6] == (3, 40, 5) and call[7] == 32
    assert call[8:] == (idx.data_ptr(), empty.data_ptr(), 7)
    assert call[6] == float(np.float32(radius * radius)) != radius * radius


def test_dispatcher_counts_pairs_and_centres():
    xyz, mask, new_xyz = _inputs(b=2, n=40, m=5)
    trace.enable()
    try:
        stack.ball_query_masked(xyz, mask, new_xyz, 0.5, 8)
    finally:
        counts = trace.disable()
    assert counts["ball_query.pairs"] == 2 * 5 * 40
    assert counts["ball_query.centres"] == 2 * 5
    assert "ball_query.kernel" not in counts  # the plain twin launched nothing


def test_shells_straddle_r2():
    """The adversarial shells on the CPU: near the origin the plain d²
    takes r² itself and the float32 values either side of it; far from it,
    the rounding puts about half the pairs in the ball."""
    radius = 0.8
    r2 = np.float32(radius * radius)
    xyz, mask, centres = cases.shells(1, 2, 16, 256, radius, (0.03, -0.02, 0.01))
    d2 = stack.pairwise_dist2(torch.as_tensor(centres), torch.as_tensor(xyz)).numpy()
    d2 = d2[np.broadcast_to(mask[:, None, :], d2.shape)]
    for v in (np.nextafter(r2, np.float32(0)), r2, np.nextafter(r2, np.float32(1))):
        assert (d2 == v).sum() > 0
    xyz, mask, centres = cases.shells(2, 2, 16, 256, radius, (61.3, -27.9, 1.4))
    d2 = stack.pairwise_dist2(torch.as_tensor(centres), torch.as_tensor(xyz)).numpy()
    assert 0.2 < float((d2 < r2).mean()) < 0.8


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _kernel_vs_plain(xyz, mask, centres, radius, nsample):
    before = stack.ball_query_cuda.launches
    got_idx, got_empty = stack.ball_query_masked(xyz, mask, centres, radius, nsample)
    assert stack.ball_query_cuda.launches == before + 1
    want_idx, want_empty = stack.ball_query_masked_plain(xyz, mask, centres, radius, nsample)
    torch.cuda.synchronize()
    assert got_idx.shape == want_idx.shape and got_idx.dtype == want_idx.dtype
    assert torch.equal(got_empty, want_empty), int((got_empty != want_empty).sum())
    assert torch.equal(got_idx, want_idx), int((got_idx != want_idx).sum())
    return got_idx, got_empty


def _cross_is_cublas_order(xyz, centres):
    """The kernel's cross term equals ``pairwise_dist2``'s torch.matmul bit
    for bit: where it does not, cuBLAS's order changed, not the kernel."""
    got = stack.ball_query_cross_cuda(xyz.contiguous(), centres.contiguous())
    want = torch.matmul(centres, xyz.transpose(-1, -2))
    assert torch.equal(got, want), f"cuBLAS's K = 3 order moved: {int((got != want).sum())}"


def _cell_queries(card):
    """The 12 ball_query_masked calls of one eval forward of the port's
    PV-RCNN at the cell's configuration, on four scans like the pool's."""
    from types import SimpleNamespace
    from unittest import mock

    from modest_tpu_torch.configs import PV_RCNN_DYNAMIC_OBJ_FULL as cfg
    from modest_tpu_torch.models import api, build_network
    from modest_tpu_torch.utils.config import Config

    data = cfg["DATA_CONFIG"]
    pcr = [float(v) for v in data["POINT_CLOUD_RANGE"]]
    voxel = next(p for p in data["DATA_PROCESSOR"]
                 if p["NAME"] == "transform_points_to_voxels")["VOXEL_SIZE"]
    grid = [int(round((pcr[i + 3] - pcr[i]) / voxel[i])) for i in range(3)]
    dataset = SimpleNamespace(point_cloud_range=pcr, voxel_size=voxel, grid_size=grid,
                              num_point_features=4, class_names=list(cfg["CLASS_NAMES"]))
    model = build_network(cfg["MODEL"], 1, device="cuda", dataset=dataset, seed=0)
    points = torch.as_tensor(bench_scans(4, cases.POINTS, 3), device=card)
    calls, real = [], stack.ball_query_masked

    def recording(*args):
        calls.append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
        return real(*args)

    with mock.patch.object(stack, "ball_query_masked", recording):
        api.apply_eval(model, Config(cfg["MODEL"]), points)
    return calls


@pytest.mark.chip
@torch.inference_mode()  # the recorded inputs are the forward's inference tensors
def test_cell_queries_bit_for_bit(card):
    calls = _cell_queries(card)
    assert len(calls) == 12  # five VSA sources and the grid pool, two radii each
    shapes = set()
    for xyz, mask, centres, radius, nsample in calls:
        _cross_is_cublas_order(xyz, centres)
        idx, empty = _kernel_vs_plain(xyz, mask, centres, radius, nsample)
        shapes.add((tuple(centres.shape), xyz.shape[1], nsample))
        assert int((~empty).sum()) > 0
    assert ((4, cases.KEYPOINTS, 3), cases.POINTS, 16) in shapes
    assert ((4, cases.ROIS * cases.GRID ** 3, 3), cases.KEYPOINTS, 16) in shapes
    assert any(ns == 32 for *_, ns in shapes)


@pytest.mark.chip
@pytest.mark.parametrize("shape", [(4, cases.POINTS), (2, 131072)], ids=["lyft", "waymo"])
def test_raw_points_and_grid_bit_for_bit(card, shape):
    b, n = shape
    xyz, mask, kp = cases.scan_clouds(b, n, 11, card)
    _cross_is_cublas_order(xyz, kp)
    for radius, nsample in cases.RAW_QUERIES:
        _kernel_vs_plain(xyz, mask, kp, radius, nsample)
    grid = cases.grid_centres(kp, 12)
    kp_mask = torch.ones(kp.shape[:2], dtype=torch.bool, device=card)
    _cross_is_cublas_order(kp, grid)
    for radius, nsample in cases.GRID_QUERIES:
        _kernel_vs_plain(kp, kp_mask, grid, radius, nsample)


@pytest.mark.chip
@pytest.mark.parametrize("nsample", [16, 32, 64])
@pytest.mark.parametrize("origin", [(0.03, -0.02, 0.01), (61.3, -27.9, 1.4)],
                         ids=["near_origin", "far"])
def test_shells_bit_for_bit(card, origin, nsample):
    radius = 0.8
    for seed, (b, m, n) in enumerate([(4, 256, 512), (2, 2048, 4096), (3, 64, 20)]):
        xyz, mask, centres = (torch.as_tensor(x, device=card)
                              for x in cases.shells(seed, b, m, n, radius, origin))
        idx, empty = _kernel_vs_plain(xyz, mask, centres, radius, nsample)
        assert not bool(empty.any())
        if origin[0] < 1:  # the plain d² takes r² and its float32 neighbours
            d2 = stack.pairwise_dist2(centres, xyz)[mask[:, None, :].expand(-1, m, -1)]
            r2 = torch.tensor(radius * radius, dtype=torch.float32, device=card)
            for v in (torch.nextafter(r2, r2.new_zeros(())), r2,
                      torch.nextafter(r2, r2.new_ones(()))):
                assert int((d2 == v).sum()) > 0


@pytest.mark.chip
def test_edge_rows_bit_for_bit(card):
    """An all-masked cloud, centres with empty balls beside full ones, N <
    nsample (the wrap-fill), N = 1, one centre, and a ragged last tile."""
    xyz, mask, centres = (torch.as_tensor(x, device=card)
                          for x in cases.shells(5, 3, 40, 1500, 0.8, (0.0, 0.0, 0.0), 0.3))
    mask[1] = False
    centres[2, ::2] += 100.0  # half the centres far from every source
    for nsample in (1, 16, 32, 64):
        idx, empty = _kernel_vs_plain(xyz, mask, centres, 0.8, nsample)
        assert bool(empty[1].all()) and bool((idx[1] == 0).all())
        assert bool(empty[2, ::2].all()) and not bool(empty[2, 1::2].any())
    for n in (1, 5, 31, 33):
        small_xyz, small_mask = xyz[:, :n].contiguous(), mask[:, :n].contiguous()
        for nsample in (16, 32):
            _kernel_vs_plain(small_xyz, small_mask, centres, 0.8, nsample)
    _kernel_vs_plain(xyz, mask, centres[:, :1].contiguous(), 0.8, 16)
    _kernel_vs_plain(xyz, mask, centres, 0.0, 16)  # r² = 0: every ball empty


@pytest.mark.chip
def test_strided_inputs_go_through_the_kernel(card):
    """The raw points as the model hands them: xyz a (B, N, 3) view of (B,
    N, 4) points. The dispatcher makes it contiguous for the kernel."""
    points = torch.as_tensor(bench_scans(2, 4096, 9), device=card)
    xyz = points[..., :3]
    assert not xyz.is_contiguous()
    mask = torch.ones(2, 4096, dtype=torch.bool, device=card)
    centres = xyz[:, ::16]
    _kernel_vs_plain(xyz, mask, centres, 0.8, 16)
