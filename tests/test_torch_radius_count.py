"""Windowed radius count in the PyTorch port vs the JAX package.

The port's plain count (what a CPU tensor runs, and what the CUDA kernel in
modest_tpu_torch/csrc/radius_count.cu is held to on the card) must equal the
Pallas kernel run in interpret mode exactly on the same sorted inputs, and a
cKDTree oracle; the tile windows must equal JAX's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from modest_tpu.ops import pallas_radius_count as jrc
from modest_tpu_torch.ops import radius_count as trc

R = 0.3


def _sorted_inputs(rng, nq_real, nq, t_count, m_real, m):
    """x-sorted queries (3, nq) and pools (T, 3, m), real points in a
    12 m cube, pads at 1e9 as in the PP path."""
    q = np.full((nq, 3), 1e9, np.float32)
    q[:nq_real] = rng.uniform(-6, 6, (nq_real, 3))
    q = q[np.argsort(q[:, 0], kind="stable")]
    pool = np.full((t_count, m, 3), 1e9, np.float32)
    for t in range(t_count):
        pool[t, :m_real[t]] = rng.uniform(-6, 6, (m_real[t], 3))
        pool[t] = pool[t][np.argsort(pool[t][:, 0], kind="stable")]
    return q.T.copy(), pool.transpose(0, 2, 1).copy()


def _jax_counts(q, pool, r):
    """JAX's windows and Pallas counts (interpret mode) on the same inputs;
    the TPU layout wants 8 coordinate rows per traversal."""
    t_count, _, m = pool.shape
    pool8 = np.zeros((t_count, 8, m), np.float32)
    pool8[:, :3] = pool
    lohi = jrc.compute_tile_windows(jnp.asarray(q[0]), jnp.asarray(pool[:, 0]), np.float32(r))
    counts = jrc.radius_count_sorted(jnp.asarray(q), jnp.asarray(pool8), lohi,
                                     np.float32(r) * np.float32(r), interpret=True)
    return np.asarray(lohi), np.asarray(counts)


def _port_counts(q, pool, r):
    qt, pt = torch.from_numpy(q), torch.from_numpy(pool)
    lohi = trc.compute_tile_windows(qt[0], pt[:, 0], torch.tensor(r, dtype=torch.float32))
    r2 = float(np.float32(r) * np.float32(r))
    return lohi.numpy(), trc.radius_count_sorted(qt, pt, lohi, r2).numpy()


@pytest.mark.parametrize("nq_real,nq,t_count,m_real", [
    (512, 512, 1, [4096]),            # full tiles, one traversal
    (600, 768, 3, [5000, 3000, 6000]),  # a tile mixing real and pad queries
    (700, 768, 2, [0, 2500]),          # an empty pool: every window empty
])
def test_plain_count_equals_pallas_interpret_and_kdtree(nq_real, nq, t_count, m_real):
    rng = np.random.RandomState(nq_real + t_count)
    m = 6144
    q, pool = _sorted_inputs(rng, nq_real, nq, t_count, m_real, m)
    j_lohi, j_counts = _jax_counts(q, pool, R)
    lohi, counts = _port_counts(q, pool, R)
    np.testing.assert_array_equal(lohi, j_lohi)
    assert counts.dtype == np.int32 and counts.shape == (t_count, nq)
    np.testing.assert_array_equal(counts, j_counts)
    for t in range(t_count):
        real = pool[t, :, :m_real[t]].T
        if len(real) == 0:
            np.testing.assert_array_equal(counts[t, :nq_real], 0)
            continue
        oracle = cKDTree(real).query_ball_point(q[:, :nq_real].T, r=R, return_length=True)
        np.testing.assert_array_equal(counts[t, :nq_real], oracle)


def test_windows_skip_far_tiles_and_cover_the_band():
    """Two query clusters far apart in x: a tile's window holds every pool
    point within r in x of the tile, and skips the far pool tiles."""
    rng = np.random.RandomState(3)
    q = np.concatenate([rng.uniform(0, 1, 256), rng.uniform(50, 51, 256)]).astype(np.float32)
    q.sort()
    pool = np.sort(rng.uniform(-10, 60, (2, 20480)).astype(np.float32), axis=1)
    lohi = trc.compute_tile_windows(torch.from_numpy(q), torch.from_numpy(pool),
                                    torch.tensor(R, dtype=torch.float32)).numpy()
    j_lohi = np.asarray(jrc.compute_tile_windows(jnp.asarray(q), jnp.asarray(pool), np.float32(R)))
    np.testing.assert_array_equal(lohi, j_lohi)
    for t in range(2):
        for i in range(2):
            tile = q[i * 256:(i + 1) * 256]
            inside = np.flatnonzero((pool[t] >= tile.min() - R) & (pool[t] <= tile.max() + R))
            lo, hi = lohi[t, i]
            assert lo * trc.BM <= inside.min() and inside.max() < hi * trc.BM
            assert hi - lo < pool.shape[1] // trc.BM


def test_point_at_exactly_r_is_counted():
    """d² = r² exactly (0.5² = 0.25 in float32): the test is inclusive."""
    q = np.full((3, 256), 1e9, np.float32)
    q[:, 0] = 0.0
    pool = np.full((1, 3, 2048), 1e9, np.float32)
    pool[0, :, :3] = [[-0.5, 0.0, 0.5], [0.0, 0.0, 0.0], [0.0, 0.5000001, 0.0]]
    pool[0] = pool[0][:, np.argsort(pool[0, 0], kind="stable")]
    _, counts = _port_counts(q, pool, 0.5)
    _, j_counts = _jax_counts(q, pool, 0.5)
    assert counts[0, 0] == 2 == j_counts[0, 0]  # (±0.5, 0, 0) in, (0, 0.5000001, 0) out


def test_dispatch_on_cpu_is_plain_and_cuda_wrapper_refuses_cpu():
    rng = np.random.RandomState(5)
    q, pool = _sorted_inputs(rng, 256, 256, 1, [2048], 2048)
    qt, pt = torch.from_numpy(q), torch.from_numpy(pool)
    lohi = trc.compute_tile_windows(qt[0], pt[:, 0], torch.tensor(R))
    before = trc.radius_count_sorted_cuda.launches
    np.testing.assert_array_equal(trc.radius_count_sorted(qt, pt, lohi, 0.09).numpy(),
                                  trc.radius_count_sorted_plain(qt, pt, lohi, 0.09).numpy())
    with pytest.raises(ValueError, match="CUDA tensors"):
        trc.radius_count_sorted_cuda(qt, pt, lohi, 0.09)
    with pytest.raises(ValueError, match="M % 2048"):
        trc.radius_count_sorted_plain(qt, pt[:, :, :1000], lohi, 0.09)
    assert trc.radius_count_sorted_cuda.launches == before


@pytest.mark.parametrize("lo,hi", [(-1, 1), (0, 2)])
def test_windows_outside_the_pool_are_refused(lo, hi):
    """A window must lie inside the pool's M / BM tiles (here 1 tile)."""
    rng = np.random.RandomState(6)
    q, pool = _sorted_inputs(rng, 256, 256, 1, [2048], 2048)
    lohi = torch.tensor([[[lo, hi]]], dtype=torch.int32)
    with pytest.raises(ValueError, match="windows inside"):
        trc.radius_count_sorted_plain(torch.from_numpy(q), torch.from_numpy(pool), lohi, 0.09)


def _work_items(lohi, chunk_tiles):
    """The work items as csrc/radius_count.cu decodes them from
    ``split_windows``: item i belongs to the last window w with
    ``starts[w] <= i`` and covers its pool tiles ``[lo + c * chunk_tiles,
    min(hi, lo + (c + 1) * chunk_tiles))`` with ``c = i - starts[w]``. (K, 4)
    int64 rows (traversal, query tile, first pool tile, end pool tile)."""
    starts = trc.split_windows(lohi, chunk_tiles).long()
    n_tiles = lohi.shape[1]
    items = torch.arange(int(starts[-1]))
    w = torch.searchsorted(starts, items, right=True) - 1
    flat = lohi.reshape(-1, 2).long()
    lo = flat[w, 0] + (items - starts[w]) * chunk_tiles
    hi = torch.minimum(flat[w, 1], lo + chunk_tiles)
    return torch.stack([w // n_tiles, w % n_tiles, lo, hi], dim=1)


def _tiles_by_window(items):
    """{(t, tile): sorted pool tiles} over the work items' chunks."""
    got = {}
    for t, tile, lo, hi in items.tolist():
        assert lo < hi  # a work item is never empty
        got.setdefault((t, tile), []).extend(range(lo, hi))
    return {k: sorted(v) for k, v in got.items()}


@pytest.mark.parametrize("chunk_tiles", [1, 2, 3, 4, 8])
def test_split_windows_covers_every_tile_once(chunk_tiles):
    """Every pool tile of every window lands in exactly one chunk of at most
    chunk_tiles tiles; (0, 0) windows give no work; windows of exactly C and
    C + 1 tiles give one and two chunks."""
    c = chunk_tiles
    lohi = torch.tensor([[[0, 0], [3, 3 + c], [0, c + 1], [5, 6]],
                         [[0, 0], [0, 0], [2, 2 + 3 * c + 1], [1, 1 + 2 * c]]], dtype=torch.int32)
    starts = trc.split_windows(lohi, c)
    assert starts.dtype == torch.int32 and starts.shape == (lohi.shape[0] * lohi.shape[1] + 1,)
    span = (lohi[..., 1] - lohi[..., 0]).reshape(-1)
    np.testing.assert_array_equal(np.diff(starts.numpy()), -(-span.numpy() // c))
    items = _work_items(lohi, c)
    assert len(items) == int(starts[-1])
    assert bool(((items[:, 3] - items[:, 2]) <= c).all())
    want = {(t, i): list(range(lo, hi)) for t in range(2) for i, (lo, hi) in
            enumerate(lohi[t].tolist()) if hi > lo}
    assert _tiles_by_window(items) == want
    per_window = {k: int(((items[:, 0] == k[0]) & (items[:, 1] == k[1])).sum()) for k in want}
    assert per_window[(0, 1)] == 1 and per_window[(0, 2)] == 2  # exactly C, C + 1 tiles
    keys = {tuple(k) for k in items[:, :2].tolist()}
    assert not keys & {(0, 0), (1, 0), (1, 1)}  # empty windows: no work


@pytest.mark.parametrize("chunk_tiles", [1, 2])
def test_plain_count_summed_over_chunks_equals_whole_and_pallas(chunk_tiles):
    """The plain twin run chunk by chunk and summed (what the kernel's
    atomic adds make) equals the plain twin run whole and the Pallas kernel
    in interpret mode, on a case whose mixed tile's window runs through the
    pool's pad points."""
    rng = np.random.RandomState(11)
    nq_real, nq, m_real, m = 600, 768, [5000, 3500], 5 * trc.BM
    q, pool = _sorted_inputs(rng, nq_real, nq, 2, m_real, m)
    _, j_counts = _jax_counts(q, pool, R)
    qt, pt = torch.from_numpy(q), torch.from_numpy(pool)
    lohi = trc.compute_tile_windows(qt[0], pt[:, 0], torch.tensor(R, dtype=torch.float32))
    mixed = nq_real // trc.BN  # real and pad queries: its window reaches the pool's end
    assert (lohi[:, mixed, 1] == m // trc.BM).all()
    assert ((lohi[:, mixed, 1] - lohi[:, mixed, 0]) > chunk_tiles).all()
    r2 = float(np.float32(R) * np.float32(R))
    whole = trc.radius_count_sorted_plain(qt, pt, lohi, r2)
    summed = torch.zeros_like(whole)
    for t, tile, lo, hi in _work_items(lohi, chunk_tiles).tolist():
        one = torch.zeros_like(lohi)
        one[t, tile] = torch.tensor([lo, hi], dtype=torch.int32)
        summed += trc.radius_count_sorted_plain(qt, pt, one, r2)
    np.testing.assert_array_equal(summed.numpy(), whole.numpy())
    np.testing.assert_array_equal(whole.numpy(), j_counts)
