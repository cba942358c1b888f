"""Point and box-geometry ops of the PyTorch port vs the JAX package.

The JAX side runs in exact mode (first-by-index ball query, exact top-k,
f32 gathers), the semantics the port targets. Inputs are made with numpy
and handed to both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modest_tpu.ops import box_jax as jb
from modest_tpu.ops import pointnet2 as jp2
from modest_tpu_torch.ops import box_torch as tb
from modest_tpu_torch.ops import pointnet2 as tp2
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module", autouse=True)
def exact_ops():
    """Exact mode is process-global (and clears jit caches): restore it."""
    prev = jp2.exact_ops()
    jp2.set_exact_ops(True)
    yield
    jp2.set_exact_ops(prev)


def _scene(seed, b=2, n=512, c=0):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32) * [4, 4, 1]
    feats = rng.randn(b, n, c).astype(np.float32) if c else None
    return pts.astype(np.float32), feats


def _t(x):
    return torch.from_numpy(np.array(x))


def test_pairwise_dist2():
    pts, _ = _scene(0)
    pts = pts * 20  # lidar-scale coordinates: |x|² in the thousands
    a, b = pts[:, :64], pts
    want = np.asarray(jp2.pairwise_dist2(jnp.asarray(a), jnp.asarray(b)))
    got = tp2.pairwise_dist2(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    assert (got >= 0).all()


@pytest.mark.parametrize("radius,nsample,n", [(0.8, 16, 512), (1.5, 8, 512), (3.0, 40, 24)])
def test_ball_query_from_same_dist2(radius, nsample, n):
    """Fed the same d2: indices equal, incl. wrap-fill (nsample > n) and an
    empty ball (a center far from every point)."""
    pts, _ = _scene(1, n=n)
    centers = pts[:, :32].copy()
    centers[:, 0] = [100.0, 100.0, 100.0]
    d2 = np.asarray(jp2.pairwise_dist2(jnp.asarray(centers), jnp.asarray(pts)))
    want_idx, want_valid = jp2.ball_query_from_dist2(jnp.asarray(d2), radius, nsample)
    got_idx, got_valid = tp2.ball_query_from_dist2(_t(d2), radius, nsample)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    assert (got_idx[:, 0] == 0).all()  # the empty ball


def test_query_and_group_and_group_all():
    pts, feats = _scene(2, c=5)
    centers = pts[:, ::8]
    d2 = np.asarray(jp2.pairwise_dist2(jnp.asarray(centers), jnp.asarray(pts)))
    want = jp2.query_and_group(jnp.asarray(pts), jnp.asarray(centers), jnp.asarray(feats),
                               jnp.asarray(d2), 0.9, 16)
    got = tp2.query_and_group(_t(pts), _t(centers), _t(feats), _t(d2), 0.9, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    want_all = jp2.group_all(jnp.asarray(pts), jnp.asarray(feats))
    np.testing.assert_array_equal(tp2.group_all(_t(pts), _t(feats)).numpy(),
                                  np.asarray(want_all))


def test_gather_points():
    pts, feats = _scene(3, c=4)
    idx = np.random.RandomState(3).randint(0, 512, (2, 100)).astype(np.int32)
    want = jp2.gather_points(jnp.asarray(feats), jnp.asarray(idx))
    np.testing.assert_array_equal(tp2.gather_points(_t(feats), _t(idx)).numpy(),
                                  np.asarray(want))


def test_three_nn_and_interpolation():
    pts, feats = _scene(4, n=400, c=6)
    unknown = pts
    known = pts[:, ::4].copy()  # every 4th point is also known: exact zeros
    kfeats = feats[:, ::4].copy()
    want_d, want_i = jp2.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    got_d, got_i = tp2.three_nn(_t(unknown), _t(known))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-5)

    w = np.random.RandomState(4).rand(2, 400, 3).astype(np.float32)
    want_t = jp2.three_interpolate(jnp.asarray(kfeats), want_i, jnp.asarray(w))
    got_t = tp2.three_interpolate(_t(kfeats), got_i, _t(w))
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=1e-5)

    want_f = jp2.interpolate_features(jnp.asarray(unknown), jnp.asarray(known),
                                      jnp.asarray(kfeats))
    got_f = tp2.interpolate_features(_t(unknown), _t(known), _t(kfeats))
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), atol=1e-5)


def test_roipoint_pool3d():
    rng = np.random.RandomState(5)
    pts = rng.uniform(-10, 10, (2, 600, 3)).astype(np.float32)
    pts[:, :150] = rng.uniform(-0.9, 0.9, (2, 150, 3)) * [2, 1, 0.7]  # inside box 0
    feats = rng.randn(2, 600, 4).astype(np.float32)
    boxes = np.array([[0, 0, 0, 4, 2, 1.5, 0.3], [50, 50, 0, 2, 2, 2, 0.3],  # empty
                      [3, -2, 0, 6, 5, 3, -1.2], [-4, 4, 0.5, 3, 3, 2, 2.0]], np.float32)
    boxes = np.stack([boxes, boxes[::-1]])
    want_p, want_e = jp2.roipoint_pool3d(jnp.asarray(pts), jnp.asarray(feats),
                                         jnp.asarray(boxes), 64, (0.1, 0.2, 0.0))
    got_p, got_e = tp2.roipoint_pool3d(_t(pts), _t(feats), _t(boxes), 64, (0.1, 0.2, 0.0))
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    assert got_e.sum() == 2


def test_box_geometry():
    rng = np.random.RandomState(6)
    boxes = np.concatenate([rng.uniform(-20, 20, (30, 3)), rng.uniform(0.5, 5, (30, 3)),
                            rng.uniform(-4, 4, (30, 1))], 1).astype(np.float32)
    pts = rng.randn(30, 10, 5).astype(np.float32)
    ang = rng.uniform(-4, 4, 30).astype(np.float32)
    np.testing.assert_allclose(
        tb.rotate_points_along_z(_t(pts), _t(ang)).numpy(),
        np.asarray(jb.rotate_points_along_z(jnp.asarray(pts), jnp.asarray(ang))), atol=1e-5)
    np.testing.assert_allclose(
        tb.boxes_to_corners_3d(_t(boxes)).numpy(),
        np.asarray(jb.boxes_to_corners_3d(jnp.asarray(boxes))), atol=1e-5)
    np.testing.assert_allclose(
        tb.limit_period(_t(ang)).numpy(), np.asarray(jb.limit_period(jnp.asarray(ang))),
        atol=1e-5)
