"""PP score in the PyTorch port vs the JAX package.

On a tiny on-disk multi-traversal dataset, the port's cached sorted-pool
counts (CPU: the plain radius count) and JAX's sorted-pool counts with the
Pallas kernel in interpret mode must both lie within a float64 cKDTree
bracket, and must be equal outside the boundary shell |d² − r²| < 1e-4 m²
(the port transforms frames in float32 elementwise steps, the JAX einsum
with fused multiply-adds, so a pair inside the shell may flip); PP must
agree to 1e-6 where no count of a point lies in the shell.
"""
import os
import shutil

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from modest_tpu.pipeline import pp_score as jpp
from modest_tpu_torch.pipeline import pp_score as tpp
from modest_tpu_torch.utils import kitti_io

R = 0.3
SHELL = 1e-4  # m², half-width of the boundary shell where counts may differ


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """3 sequences of 2 frames, 3000 points each in a 16 m box, small random
    poses; origin 0 looks at sequences 1 (2 frames), 2 (1 frame) and 0."""
    rng = np.random.RandomState(7)
    root = tmp_path_factory.mktemp("pp")
    for sub in ["velodyne", "oxts", "l2e"]:
        os.makedirs(root / sub)
    track_list = [[0, 1], [2, 3], [4, 5]]
    for gid in range(6):
        n = 3000 - 150 * gid
        pts = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
        kitti_io.save_velo_scan(root / "velodyne" / f"{gid:06d}.bin",
                                np.concatenate([pts, np.zeros((n, 1), np.float32)], 1))
        (root / "oxts" / f"{gid:06d}.txt").write_text(
            f"{rng.randn() * 0.3} {rng.randn() * 0.3} 0 0 0 {rng.randn() * 0.05}\n")
        np.save(root / "l2e" / f"{gid:06d}.npy", np.eye(4, dtype=np.float32))
    valid_idx = {0: (0, 0, [(1, [0, 1]), (2, [0]), (0, [0, 1])])}
    return root, track_list, valid_idx


def _shell_bounds(index, origin_idx):
    """(n, T) counts within sqrt(r² − SHELL) and sqrt(r² + SHELL), in
    float64 from the same float32 poses: a count outside this bracket is
    wrong; a count where the two agree must be exact."""
    _, _, neighbors = index.valid_idx[origin_idx]
    combined, trans_mat = index.combined_traversals(origin_idx)
    q = index.origin_cloud(origin_idx)[:, :3].astype(np.float64) @ \
        trans_mat[:3, :3].T.astype(np.float64) + trans_mat[:3, 3]
    inner, outer = [], []
    for seq_id, _ in neighbors:
        tree = cKDTree(combined[seq_id].astype(np.float64))
        inner.append(tree.query_ball_point(q, r=np.sqrt(R * R - SHELL), return_length=True))
        outer.append(tree.query_ball_point(q, r=np.sqrt(R * R + SHELL), return_length=True))
    return np.stack(inner, 1), np.stack(outer, 1)


def test_cached_counts_and_pp_match_jax_pallas(dataset):
    root, track_list, valid_idx = dataset
    j_index = jpp.TraversalIndex(root, track_list, valid_idx)
    j_cache = jpp.DeviceFrameCache(j_index._velo, chunk=1024)
    want, n = jpp.pp_counts_cached_sorted(j_index, j_cache, 0, R, interpret=True)

    index = tpp.TraversalIndex(root, track_list, valid_idx)
    cache = tpp.FrameCache(index._velo, device="cpu", chunk=1024)
    got, n_got = tpp.pp_counts_cached_sorted(index, cache, 0, R)
    assert n_got == n == 3000 and got.shape == want.shape == (3000, 3)

    inner, outer = _shell_bounds(index, 0)
    for counts in (got, want):
        assert ((counts >= inner) & (counts <= outer)).all()
    exact = inner == outer
    assert exact.mean() > 0.99 and got.sum() > 3000  # the shell is thin; counts are not trivial
    np.testing.assert_array_equal(got[exact], want[exact])

    pp = tpp.pp_score_for_frame_cached(index, cache, 0, R)
    assert pp.dtype == np.float32 and pp.shape == (3000,)
    rows = exact.all(axis=1)
    np.testing.assert_allclose(pp[rows], jpp.compute_ephe_score(want).astype(np.float32)[rows],
                               atol=1e-6)


def test_uncached_entry_point_matches_cached(dataset):
    root, track_list, valid_idx = dataset
    index = tpp.TraversalIndex(root, track_list, valid_idx)
    cached = tpp.pp_score_for_frame_cached(index, tpp.FrameCache(index._velo, "cpu", chunk=1024),
                                           0, R)
    np.testing.assert_allclose(tpp.pp_score_for_frame(index, 0, R, device="cpu"), cached,
                               atol=2e-5)
    noisy = tpp.pp_score_for_frame(index, 0, R, add_random_noise=0.5,
                                   rng=np.random.RandomState(0), device="cpu")
    assert noisy.shape == cached.shape and not np.allclose(noisy, cached)


def test_empty_origin_cloud(dataset, tmp_path):
    """n = 0 gives an empty score, as the JAX float32 path does."""
    root, track_list, valid_idx = dataset
    empty = tmp_path / "empty"
    shutil.copytree(root, empty)
    kitti_io.save_velo_scan(empty / "velodyne" / "000000.bin", np.zeros((0, 4), np.float32))
    valid_idx = {0: (0, 0, [(1, [0, 1]), (2, [0])])}
    index = tpp.TraversalIndex(empty, track_list, valid_idx)
    pp = tpp.pp_score_for_frame_cached(index, tpp.FrameCache(index._velo, "cpu"), 0, R)
    assert pp.shape == (0,) and pp.dtype == np.float32
    assert tpp.pp_score_for_frame(index, 0, R, device="cpu").shape == (0,)
    j_index = jpp.TraversalIndex(empty, track_list, valid_idx)
    j_counts, n = jpp.pp_counts_cached_sorted(j_index, jpp.DeviceFrameCache(j_index._velo), 0, R,
                                              interpret=True)
    assert n == 0 and j_counts.shape == (0, 2)


def test_frame_cache_lru_bound_and_one_pad_size():
    sizes = {0: 5000, 1: 8000, 2: 100, 3: 9000}
    loads = []

    def load(gid):
        loads.append(gid)
        return np.full((sizes[gid], 3), gid, np.float32)

    cache = tpp.FrameCache(load, device="cpu", max_frames=2)
    a, ma = cache.frame(0)
    assert cache.m_pad == 8192 and a.shape == (8192, 3) and int(ma.sum()) == 5000
    b, mb = cache.frame(1)  # every frame takes the first frame's pad size
    assert b.shape == (8192, 3) and int(mb.sum()) == 8000
    cache.frame(0)          # a hit moves frame 0 to the back
    cache.frame(2)          # evicts frame 1, the least recently used
    assert len(cache) == 2
    cache.frame(0)
    cache.frame(1)
    assert loads == [0, 1, 2, 1]
    with pytest.raises(ValueError, match="above the cache"):
        cache.frame(3)


def test_compute_ephe_score_and_remove_center_match_jax():
    rng = np.random.RandomState(0)
    counts = np.concatenate([rng.randint(0, 50, (200, 4)), [[0, 0, 0, 0], [8, 0, 0, 0]]])
    got = tpp.compute_ephe_score(counts)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, jpp.compute_ephe_score(counts), rtol=0, atol=1e-12)
    pts = rng.uniform(-3, 3, (500, 3))
    np.testing.assert_array_equal(tpp.remove_center(pts), jpp.remove_center(pts))


def test_entry_points_run_on_the_card_unless_asked_for_the_cpu(dataset):
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the refusal needs a host without one")
    root, track_list, valid_idx = dataset
    index = tpp.TraversalIndex(root, track_list, valid_idx)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpp.FrameCache(index._velo)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpp.pp_score_for_frame(index, 0, R)
