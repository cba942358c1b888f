"""Box coders, rotated IoU and greedy NMS of the PyTorch port vs the JAX
package, on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modest_tpu.models import box_coders as jbc
from modest_tpu.ops import iou3d as jiou
from modest_tpu_torch.models import box_coders as tbc
from modest_tpu_torch.ops import iou3d as tiou
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _boxes(rng, n, spread=20.0):
    return np.concatenate([
        rng.uniform(-spread, spread, (n, 2)), rng.uniform(-1, 1, (n, 1)),
        rng.uniform(1, 5, (n, 2)), rng.uniform(1, 2, (n, 1)),
        rng.uniform(-np.pi, np.pi, (n, 1)),
    ], 1).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_residual_coder_roundtrip():
    rng = np.random.RandomState(0)
    boxes, anchors = _boxes(rng, 64), _boxes(rng, 64)
    j, t = jbc.ResidualCoder(), tbc.ResidualCoder()
    enc_j = np.asarray(j.encode(jnp.asarray(boxes), jnp.asarray(anchors)))
    enc_t = t.encode(_t(boxes), _t(anchors))
    np.testing.assert_allclose(enc_t.numpy(), enc_j, atol=1e-5)
    dec_j = np.asarray(j.decode(jnp.asarray(enc_j), jnp.asarray(anchors)))
    np.testing.assert_allclose(t.decode(_t(enc_j), _t(anchors)).numpy(), dec_j, atol=1e-5)


def test_point_residual_coder_roundtrip():
    rng = np.random.RandomState(1)
    mean_size = [[3.9, 1.6, 1.56], [0.8, 0.6, 1.73], [1.76, 0.6, 1.73]]
    boxes = _boxes(rng, 64)
    pts = rng.uniform(-20, 20, (64, 3)).astype(np.float32)
    cls = rng.randint(0, 4, 64).astype(np.int32)  # 0 reads the first mean size
    j = jbc.PointResidualCoder(mean_size=mean_size)
    t = tbc.PointResidualCoder(mean_size=mean_size)
    enc_j = np.asarray(j.encode(jnp.asarray(boxes), jnp.asarray(pts), jnp.asarray(cls)))
    np.testing.assert_allclose(t.encode(_t(boxes), _t(pts), _t(cls)).numpy(), enc_j, atol=1e-5)
    enc = rng.randn(64, 8).astype(np.float32)
    dec_j = np.asarray(j.decode(jnp.asarray(enc), jnp.asarray(pts), jnp.asarray(cls)))
    np.testing.assert_allclose(t.decode(_t(enc), _t(pts), _t(cls)).numpy(), dec_j, atol=1e-5)


def test_iou_bev_and_3d():
    rng = np.random.RandomState(2)
    a = _boxes(rng, 40, spread=4.0)
    b = np.concatenate([_boxes(rng, 30, spread=4.0), a[:10]])  # identical pairs too
    want_bev = np.asarray(jiou.boxes_iou_bev(jnp.asarray(a), jnp.asarray(b)))
    got_bev = tiou.boxes_iou_bev(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(got_bev, want_bev, atol=1e-5)
    assert (want_bev > 0.1).sum() > 50  # the overlaps are not all empty
    want_3d = np.asarray(jiou.boxes_iou3d(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(tiou.boxes_iou3d(_t(a), _t(b)).numpy(), want_3d, atol=1e-5)


@pytest.mark.parametrize("n,max_keep,thresh", [(200, 64, 0.1), (1500, 100, 0.3)])
def test_nms_keep_sets_equal_greedy_scan(n, max_keep, thresh):
    """Keep sets equal JAX's row-at-a-time greedy scan (the oracle of both
    JAX branches: the full-matrix one for n <= 1024, _nms_blocked above).
    Two scenes in one batch; some rows are -inf (never kept)."""
    rng = np.random.RandomState(n)
    boxes = np.stack([_boxes(rng, n, spread=15.0), _boxes(rng, n, spread=15.0)])
    scores = rng.rand(2, n).astype(np.float32)
    scores[:, ::7] = -np.inf
    scores[1, 10:20] = scores[1, 20]  # equal scores: ties go to the lower index
    got_idx, got_mask = tiou.nms_bev(_t(boxes), _t(scores), thresh, max_keep)
    for i in range(2):
        want_idx, want_mask = jiou._nms_scan_reference(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]), thresh, max_keep)
        want_mask = np.asarray(want_mask)
        np.testing.assert_array_equal(got_mask[i].numpy(), want_mask)
        np.testing.assert_array_equal(got_idx[i].numpy()[want_mask],
                                      np.asarray(want_idx)[want_mask])
    assert got_mask.sum() > max_keep  # enough keeps that suppression mattered
