"""Stacked (ragged) PointNet++ ops of the PyTorch port vs the JAX package.

``modest_tpu_torch/ops/pointnet2_stack.py`` against
``modest_tpu/ops/pointnet2_stack.py`` on the CPU, with seeded numpy inputs:
ragged counts, clouds with fewer points than samples, empty clouds, empty
balls and padding centres. FPS indices are equal; distances agree within
rtol 1e-5. The FPS kernels' route (padding set to each cloud's point 0, one
unmasked FPS for the batch) is held here through the unmasked plain FPS,
whose arithmetic the kernels equal bit for bit on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modest_tpu.ops import pointnet2 as jp2
from modest_tpu.ops import pointnet2_stack as js
from modest_tpu_torch.ops import pointnet2_stack as ts
from modest_tpu_torch.ops.fps import furthest_point_sample_plain
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def exact_ops():
    """Exact mode is process-global (and clears jit caches): restore it."""
    prev = jp2.exact_ops()
    jp2.set_exact_ops(True)
    yield
    jp2.set_exact_ops(prev)


def _ragged(seed, cnts, c=3, scale=10.0, n_max=None):
    """Padded (B, n_max, c) float32 of uniform points, its counts, the flat
    stacked array; the padding is random too, so a kept padding row shows."""
    rng = np.random.RandomState(seed)
    cnts = np.asarray(cnts, np.int32)
    n_max = int(cnts.max()) if n_max is None else n_max
    padded = (rng.rand(len(cnts), n_max, c) * scale).astype(np.float32)
    flat = np.concatenate([padded[i, :k] for i, k in enumerate(cnts)], axis=0)
    return padded, cnts, flat


@pytest.mark.parametrize("cnts,n_max", [([5, 9, 2], None), ([0, 4, 7], 10), ([3], None)])
def test_stack_padded_round_trip(cnts, n_max):
    _, cnt, flat = _ragged(0, cnts, c=4)
    got, got_cnt = ts.stack_to_padded(flat, cnt, n_max)
    want, want_cnt = js.stack_to_padded(flat, cnt, n_max)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_cnt, want_cnt)
    assert got_cnt.dtype == np.int32
    np.testing.assert_array_equal(ts.padded_to_stack(got, got_cnt),
                                  js.padded_to_stack(want, want_cnt))
    np.testing.assert_array_equal(ts.padded_to_stack(got, got_cnt), flat)


def test_mask_from_counts():
    cnt = np.array([0, 3, 6], np.int32)
    want = np.asarray(js.mask_from_counts(jnp.asarray(cnt), 6))
    np.testing.assert_array_equal(ts.mask_from_counts(torch.from_numpy(cnt), 6).numpy(), want)


def _duplicates(seed):
    """Clouds of 40 points on 5 distinct sites: every step past the fifth
    meets ties at distance 0."""
    rng = np.random.RandomState(seed)
    sites = (rng.rand(2, 5, 3) * 4).astype(np.float32)
    pts = sites[:, rng.randint(0, 5, 40)]
    return pts, np.array([40, 23], np.int32)


FPS_CASES = {
    "ragged": ([300, 120, 257, 64], None, 64),
    "cnt_below_npoint": ([300, 17, 1], None, 48),
    "cnt_zero": ([0, 90, 0], 96, 32),
    "npoint_1": ([12, 0], None, 1),
}


@pytest.mark.parametrize("case", [*FPS_CASES, "duplicates"])
def test_fps_stack_indices_equal_jax(case):
    if case == "duplicates":
        xyz, cnt = _duplicates(1)
        npoint = 16
    else:
        cnts, n_max, npoint = FPS_CASES[case]
        xyz, cnt, _ = _ragged(1, cnts, n_max=n_max)
    want = np.asarray(js.farthest_point_sample_stack(jnp.asarray(xyz), jnp.asarray(cnt), npoint))
    got = ts.farthest_point_sample_stack(torch.from_numpy(xyz), torch.from_numpy(cnt), npoint)
    assert got.dtype == torch.int32 and got.shape == (len(cnt), npoint)
    np.testing.assert_array_equal(got.numpy(), want)
    for b, c in enumerate(cnt):  # padding never chosen; an empty cloud gives index 0
        assert (got[b] < max(int(c), 1)).all()
    # the kernels' route: padding set to point 0, unmasked FPS for the whole batch
    filled = ts.padding_at_first_point(torch.from_numpy(xyz), torch.from_numpy(cnt))
    np.testing.assert_array_equal(furthest_point_sample_plain(filled, npoint).numpy(), want)


def test_padding_at_first_point_layout():
    xyz, cnt, _ = _ragged(2, [3, 0, 5], n_max=5)
    filled = ts.padding_at_first_point(torch.from_numpy(xyz), torch.from_numpy(cnt)).numpy()
    assert filled.dtype == np.float32 and filled.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(filled[0, :3], xyz[0, :3])
    np.testing.assert_array_equal(filled[0, 3:], np.broadcast_to(xyz[0, 0], (2, 3)))
    np.testing.assert_array_equal(filled[1], 0.0)
    np.testing.assert_array_equal(filled[2], xyz[2])


def test_masked_pairwise_dist2():
    a, a_cnt, _ = _ragged(3, [20, 7], scale=30.0)
    b, b_cnt, _ = _ragged(4, [50, 33], scale=30.0)
    want = np.asarray(js.masked_pairwise_dist2(jnp.asarray(a), jnp.asarray(a_cnt),
                                               jnp.asarray(b), jnp.asarray(b_cnt)))
    got = ts.masked_pairwise_dist2(torch.from_numpy(a), torch.from_numpy(a_cnt),
                                   torch.from_numpy(b), torch.from_numpy(b_cnt)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-4)
    np.testing.assert_array_equal(got == ts.BIG, want == js.BIG)


def _ball_inputs(seed):
    """Two clouds of 120 and 80 points with counts, 30 centres each (the
    second cloud's last 6 padding), two centres far from every point."""
    xyz, xyz_cnt, _ = _ragged(seed, [120, 80], scale=5.0)
    new, _, _ = _ragged(seed + 1, [30, 30], scale=5.0)
    new[0, 3] = [100.0, 100.0, 100.0]
    new[1, 0] = [-50.0, 0.0, 0.0]
    return xyz, xyz_cnt, new, np.array([30, 24], np.int32)


@pytest.mark.parametrize("radius,nsample", [(1.0, 16), (0.4, 8), (2.5, 40)])
def test_ball_query_stack(radius, nsample):
    xyz, xyz_cnt, new, new_cnt = _ball_inputs(5)
    want_idx, want_empty = js.ball_query_stack(jnp.asarray(xyz), jnp.asarray(xyz_cnt),
                                               jnp.asarray(new), jnp.asarray(new_cnt),
                                               radius, nsample)
    got_idx, got_empty = ts.ball_query_stack(torch.from_numpy(xyz), torch.from_numpy(xyz_cnt),
                                             torch.from_numpy(new), torch.from_numpy(new_cnt),
                                             radius, nsample)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_empty.numpy(), np.asarray(want_empty))
    assert got_empty[0, 3] and got_empty[1, 0] and got_empty[1, 24:].all()
    assert (got_idx[0] < 120).all() and (got_idx[1] < 80).all()


@pytest.mark.parametrize("with_features,use_xyz", [(True, True), (True, False), (False, True)])
def test_query_and_group_stack(with_features, use_xyz):
    xyz, xyz_cnt, new, new_cnt = _ball_inputs(7)
    feats = np.random.RandomState(8).randn(2, 120, 5).astype(np.float32)
    want, want_empty = js.query_and_group_stack(
        jnp.asarray(xyz), jnp.asarray(xyz_cnt), jnp.asarray(feats) if with_features else None,
        jnp.asarray(new), jnp.asarray(new_cnt), 1.2, 16, use_xyz=use_xyz)
    got, got_empty = ts.query_and_group_stack(
        torch.from_numpy(xyz), torch.from_numpy(xyz_cnt),
        torch.from_numpy(feats) if with_features else None, torch.from_numpy(new),
        torch.from_numpy(new_cnt), 1.2, 16, use_xyz=use_xyz)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-6)
    np.testing.assert_array_equal(got_empty.numpy(), np.asarray(want_empty))
    assert (got[got_empty] == 0).all()


def test_three_nn_stack():
    known, known_cnt, _ = _ragged(9, [10, 6, 40])
    unknown, unknown_cnt, _ = _ragged(10, [20, 20, 13])
    want_d, want_idx = js.three_nn_stack(jnp.asarray(unknown), jnp.asarray(unknown_cnt),
                                         jnp.asarray(known), jnp.asarray(known_cnt))
    got_d, got_idx = ts.three_nn_stack(torch.from_numpy(unknown), torch.from_numpy(unknown_cnt),
                                       torch.from_numpy(known), torch.from_numpy(known_cnt))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=RTOL)
    for b, k in enumerate(known_cnt):
        assert (got_idx[b] < k).all()
