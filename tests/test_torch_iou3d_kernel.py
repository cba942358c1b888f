"""The rotated-IoU kernel (modest_tpu_torch/csrc/iou3d.cu) and its dispatch.

On the CPU: ``boxes_overlap_bev`` sends CPU tensors to the plain twin,
``boxes_overlap_bev_cuda`` refuses what the kernel does not take before it
builds or launches anything, the operands it hands the kernel (batch and row
strides, a stride-0 broadcast batch) read as the plain path's broadcast,
and the plain twin agrees with the JAX package on the adversarial box sets
of ``modest_tpu_torch/tools/iou_cases.py``.

On the card (marker ``chip``; skipped where no CUDA device is visible): the
kernel equals the plain twin bit for bit on those sets, at the NMS shapes of
the benchmark's cells, in float32 and float64, with a stride-0 operand and
8-value rows; and ``nms_bev`` keeps the same boxes through either. Run them
there with ``python -m pytest tests/test_torch_iou3d_kernel.py -m chip
--noconftest``: ``tests/conftest.py`` and the CPU parity test import JAX,
which the card's machine lacks, and this module imports it only inside
that test.
"""
import math

import numpy as np
import pytest
import torch

from modest_tpu_torch.ops import iou3d
from modest_tpu_torch.tools import iou_cases
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


def _t(x, dtype=torch.float32, device="cpu"):
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _kept_candidates(monkeypatch, boxes_a, boxes_b):
    """The most candidates the plain clip keeps at any edge, per pair: the
    row sums of the keep masks its compaction scans."""
    seen, cumsum = [], torch.cumsum

    def recording(x, dim, *args, **kwargs):
        seen.append(x.sum(-1))
        return cumsum(x, dim, *args, **kwargs)

    monkeypatch.setattr(torch, "cumsum", recording)
    iou3d.boxes_overlap_bev_plain(boxes_a, boxes_b)
    monkeypatch.setattr(torch, "cumsum", cumsum)
    return torch.stack(seen).amax(0)


def test_cpu_tensors_take_the_plain_twin(monkeypatch):
    def refuse(*args):
        raise AssertionError("a CPU tensor reached the kernel's wrapper")

    monkeypatch.setattr(iou3d, "boxes_overlap_bev_cuda", refuse)
    names, boxes = iou_cases.adversarial_boxes()
    a = _t(boxes)
    got = iou3d.boxes_overlap_bev(a, a)
    assert torch.equal(got, iou3d.boxes_overlap_bev_plain(a, a))
    assert got.shape == (len(names), len(names))
    iou = iou3d.boxes_iou_bev(a[None], a[None])  # the NMS's entry, batched
    assert iou.shape == (1, len(names), len(names))


@pytest.mark.parametrize("boxes_a,boxes_b,match", [
    (torch.zeros(3, 7), torch.zeros(2, 7), "CUDA tensors"),
    (torch.zeros(3, 7, dtype=torch.float16), torch.zeros(2, 7, dtype=torch.float16), "float32"),
    (torch.zeros(3, 7, dtype=torch.int64), torch.zeros(2, 7, dtype=torch.int64), "float32"),
    (torch.zeros(3, 7), torch.zeros(2, 7, dtype=torch.float64), "one dtype"),
    (torch.zeros(3, 6), torch.zeros(2, 6), "rows, 7"),
    (torch.zeros(7), torch.zeros(2, 7), "rows, 7"),
    (torch.zeros(2, 3, 7), torch.zeros(3, 2, 7), "do not broadcast"),
], ids=["cpu", "float16", "int64", "mixed_dtypes", "six_values", "one_dim", "no_broadcast"])
def test_cuda_wrapper_refuses_without_building_or_launching(monkeypatch, boxes_a, boxes_b,
                                                            match):
    def no_build():
        raise AssertionError("the wrapper built the kernel for an input it refuses")

    monkeypatch.setattr(iou3d, "_lib", no_build)
    before = iou3d.boxes_overlap_bev_cuda.launches
    with pytest.raises(ValueError, match=match):
        iou3d.boxes_overlap_bev_cuda(boxes_a, boxes_b)
    assert iou3d.boxes_overlap_bev_cuda.launches == before


def _as_kernel_reads(x, row_stride=None):
    """``x`` at the kernel's addresses: its storage read from its offset
    with its batch stride, ``row_stride`` (its own by default) and unit steps
    after that."""
    flat = torch.empty(0, dtype=x.dtype).set_(x.untyped_storage())
    strides = (x.stride(0), x.stride(1) if row_stride is None else row_stride, 1)
    return flat.as_strided(x.shape, strides[:x.ndim], x.storage_offset())


def _operand_cases():
    rng = np.random.RandomState(5)
    boxes = lambda *shape: _t(iou_cases.scene_boxes(rng, shape, spread=6.0))  # noqa: E731
    anchors = boxes(40)
    gt8 = torch.cat([boxes(3, 9), torch.ones(3, 9, 1)], -1)  # (B, M, 8), class last
    kept = torch.cat([boxes(2, 12), torch.zeros(2, 1, 7)], 1)[:, :12]  # _nms_bev's slice
    return {
        "plain_2d": (boxes(9), boxes(11), ("copy_free",)),
        "batched": (boxes(3, 9), boxes(3, 11), ()),
        "broadcast_rows": (boxes(3, 9), boxes(11), ("b_stride0",)),
        "anchors_expanded_gt_sliced": (anchors.expand(3, -1, -1), gt8[..., :7],
                                       ("a_stride0", "b_row8")),
        "kept_slice": (kept, boxes(2, 16), ("a_sliced",)),
        "lead_2x3": (boxes(2, 1, 5), boxes(3, 6), ()),
        "values_strided": (torch.stack([boxes(6), boxes(6)], -1).reshape(6, 14)[:, ::2],
                           boxes(4), ("a_copied",)),
    }


@pytest.mark.parametrize("case", list(_operand_cases()))
def test_kernel_operands_read_as_the_broadcast(case):
    """The operands the wrapper gives the kernel, read at the kernel's
    addresses batch by batch, give the plain path's (..., N, M) result."""
    boxes_a, boxes_b, expect = _operand_cases()[case]
    lead = torch.broadcast_shapes(boxes_a.shape[:-2], boxes_b.shape[:-2])
    n, m = boxes_a.shape[-2], boxes_b.shape[-2]
    a, a_cos, a_sin = iou3d._kernel_operand(boxes_a, lead, n)
    b, b_cos, b_sin = iou3d._kernel_operand(boxes_b, lead, m)
    size = math.prod(lead)
    assert a.shape == (size, n, 7) and b.shape == (size, m, 7)
    assert a.stride(2) == 1 and b.stride(2) == 1
    ra, rb = _as_kernel_reads(a), _as_kernel_reads(b)
    got = torch.stack([iou3d.boxes_overlap_bev_plain(ra[i], rb[i])
                       for i in range(size)]).reshape(*lead, n, m)
    assert torch.equal(got, iou3d.boxes_overlap_bev_plain(boxes_a, boxes_b))
    # the headings' cosine and sine, one batch stride for both, row stride 1
    for boxes, rows, x, cos, sin in ((boxes_a, n, ra, a_cos, a_sin),
                                     (boxes_b, m, rb, b_cos, b_sin)):
        assert cos.shape == sin.shape == (size, rows) and cos.stride(0) == sin.stride(0)
        heading = boxes.expand(*lead, rows, 7)[..., 6].reshape(size, rows)
        assert torch.equal(x[..., 6], heading)
        assert torch.equal(_as_kernel_reads(cos, 1), torch.cos(heading))
        assert torch.equal(_as_kernel_reads(sin, 1), torch.sin(heading))
    if "copy_free" in expect:
        assert a.data_ptr() == boxes_a.data_ptr() and b.data_ptr() == boxes_b.data_ptr()
    if "a_stride0" in expect:
        assert a.stride(0) == 0 and a.data_ptr() == boxes_a.data_ptr()
    if "b_stride0" in expect:
        assert b.stride(0) == 0 and b.data_ptr() == boxes_b.data_ptr()
    if "b_row8" in expect:
        assert b.stride(1) == 8 and b.data_ptr() == boxes_b.data_ptr()
    if "a_copied" in expect:
        assert a.data_ptr() != boxes_a.data_ptr() and a.is_contiguous()
    if "a_sliced" in expect:
        assert a.stride(0) == 13 * 7 and a.data_ptr() == boxes_a.data_ptr()


def test_adversarial_boxes_agree_with_jax(monkeypatch):
    """The plain twin against the JAX package's clip on every ordered pair
    of the adversarial and the near-coincident boxes, float32: IoU within
    1e-5 (the port's IoU parity tolerance), areas within 1e-5 of their size.
    An all-zero clip box keeps its subject whole in both, and its IoU then
    divides two roundings of zero (the NMS masks those rows), so for it the
    areas are compared."""
    import jax.numpy as jnp

    from modest_tpu.ops import iou3d as jiou

    names, boxes = iou_cases.adversarial_boxes()
    a = np.concatenate([boxes, iou_cases.near_coincident_boxes()]).astype(np.float32)
    got_ov = iou3d.boxes_overlap_bev(_t(a), _t(a)).numpy()
    want_ov = np.asarray(jiou.boxes_overlap_bev(jnp.asarray(a), jnp.asarray(a)))
    np.testing.assert_allclose(got_ov, want_ov, rtol=1e-5, atol=1e-5)
    got = iou3d.boxes_iou_bev(_t(a), _t(a)).numpy()
    want = np.asarray(jiou.boxes_iou_bev(jnp.asarray(a), jnp.asarray(a)))
    clip_real = (a[:, 3] * a[:, 4] > 0)[:, None]
    assert not clip_real[names.index("zero_row")] and clip_real.sum() == len(a) - 1
    np.testing.assert_allclose(np.where(clip_real, got, 0), np.where(clip_real, want, 0),
                               atol=1e-5)
    a = _t(boxes)
    kept = _kept_candidates(monkeypatch, a, a)
    square, turned = names.index("square"), names.index("square_45")
    assert int(kept[square, turned]) == 8  # the octagon fills every slot
    assert int(kept.max()) == 8


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card_sets():
    names, adv = iou_cases.adversarial_boxes()
    _, tol = iou_cases.tolerance_boxes()
    near = iou_cases.near_coincident_boxes()
    sets = {"adversarial": (adv, adv), "tolerance": (tol, tol), "near_coincident": (near, near)}
    for name, b, kept, block in iou_cases.NMS_SHAPES:
        sets[f"nms_{name}"] = iou_cases.nms_operands(b, kept, block)
    return sets


def _kernel_vs_plain(boxes_a, boxes_b):
    before = iou3d.boxes_overlap_bev_cuda.launches
    got = iou3d.boxes_overlap_bev(boxes_a, boxes_b)
    assert iou3d.boxes_overlap_bev_cuda.launches == before + 1
    want = iou3d.boxes_overlap_bev_plain(boxes_a, boxes_b)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want), (got - want).abs().max().item()


@pytest.mark.chip
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("case", list(_card_sets()))
def test_kernel_equals_plain_twin_bit_for_bit(card, case, dtype):
    boxes_a, boxes_b = _card_sets()[case]
    _kernel_vs_plain(_t(boxes_a, dtype, card), _t(boxes_b, dtype, card))


@pytest.mark.chip
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_kernel_strided_operands_bit_for_bit(card, dtype):
    """A stride-0 batch (ATSS's expanded anchors), 8-value gt rows (the RoI
    sampler's ``gt_boxes[..., :7]``) and ``_nms_bev``'s sliced kept rows."""
    rng = np.random.RandomState(3)
    anchors = _t(iou_cases.scene_boxes(rng, (300,)), dtype, card)
    gt = _t(np.concatenate([iou_cases.scene_boxes(rng, (4, 20)), np.ones((4, 20, 1))], -1),
            dtype, card)
    _kernel_vs_plain(anchors.expand(4, -1, -1), gt[..., :7])
    kept = torch.cat([_t(iou_cases.scene_boxes(rng, (4, 100)), dtype, card),
                      torch.zeros(4, 1, 7, dtype=dtype, device=card)], 1)[:, :100]
    _kernel_vs_plain(kept, _t(iou_cases.scene_boxes(rng, (4, 256)), dtype, card))
    _kernel_vs_plain(gt[..., :7], anchors)  # a 2-D operand broadcast over the batch


@pytest.mark.chip
@pytest.mark.parametrize("cell", [c[0] for c in iou_cases.NMS_CELLS])
def test_nms_keep_sets_equal_through_the_kernel(card, cell, monkeypatch):
    _, b, n, valid, max_keep, thresh = next(c for c in iou_cases.NMS_CELLS if c[0] == cell)
    boxes, scores = iou_cases.nms_inputs(b, n, valid)
    boxes, scores = _t(boxes, device=card), _t(scores, device=card)
    before = iou3d.boxes_overlap_bev_cuda.launches
    got_idx, got_mask = iou3d.nms_bev(boxes, scores, thresh, max_keep)
    assert iou3d.boxes_overlap_bev_cuda.launches > before
    monkeypatch.setattr(iou3d, "boxes_overlap_bev_cuda", iou3d.boxes_overlap_bev_plain)
    want_idx, want_mask = iou3d.nms_bev(boxes, scores, thresh, max_keep)
    assert torch.equal(got_mask, want_mask) and torch.equal(got_idx, want_idx)
    assert int(got_mask.sum()) > 0
