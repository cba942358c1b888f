"""Windowed kNN in the PyTorch port vs the JAX package.

The port's plain window function (what a CPU tensor runs, and what the CUDA
kernel in modest_tpu_torch/csrc/knn.cu is held to on the card) against the
Pallas kernel run in interpret mode on the same packed inputs; the port's
``nearest_k`` against ``pallas_knn.nearest_k`` in both modes; the dense
fallback, the shape rules and the two sorts' tie order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modest_tpu.ops import pallas_knn as pk
from modest_tpu.ops import pointnet2 as jp2
from modest_tpu_torch.ops import knn as tk
from modest_tpu_torch.ops.pointnet2 import nearest_topk
from modest_tpu_torch.tools import knn_bench

QUANTUM = 2.0 ** -11  # the key keeps d² to ~2^-12 relative; allow one more bit


def _cloud(rng, b, n, lo=(0, -40, -2), hi=(80, 40, 1)):
    return rng.uniform(lo, hi, (b, n, 3)).astype(np.float32)


def _exact_d2(q, c):
    """float64 squared distances, (..., 3) and (..., 3)."""
    return ((q.astype(np.float64) - c.astype(np.float64)) ** 2).sum(-1)


def _assert_keys_match_pallas(args, w, k, b):
    """The packed keys of the plain twin and of the Pallas kernel (interpret
    mode) on the same inputs. XLA's CPU may fuse the d² sum into FMAs, so a
    key may differ by a quantum: at most 0.1% of the slots may differ, and
    each such slot's exact d² must lie within 2^-11 relative of the other."""
    bm = args[0].shape[0]
    got = tk.knn_windows(*args, w=w, k=k, frames=b).numpy()
    want = np.asarray(pk._knn_windows(*(jnp.asarray(a.numpy()) for a in args), w=w, k=k,
                                      interpret=True))
    assert got.shape == want.shape == (bm, k) and got.dtype == np.int32
    assert np.all(np.diff(got, axis=1) > 0)  # ascending, unique
    diff = got != want
    assert diff.mean() <= 1e-3, f"{diff.sum()} of {diff.size} slots differ"
    qx, qy, qz, xs, ys, zs, lo = (a.numpy() for a in args)
    cand = np.stack([xs.reshape(-1), ys.reshape(-1), zs.reshape(-1)], -1)
    q = np.concatenate([qx, qy, qz], 1)
    for r, s in zip(*np.nonzero(diff)):
        base = lo[r // tk.QC] * tk.ROW
        d_got = _exact_d2(q[r], cand[base + (got[r, s] & (w - 1))])
        d_want = _exact_d2(q[r], cand[base + (want[r, s] & (w - 1))])
        assert abs(d_got - d_want) <= QUANTUM * max(d_got, d_want)
    return got


@pytest.mark.parametrize("n,w", [(1024, 512), (2048, 1024)])
def test_plain_window_function_matches_pallas_interpret(n, w):
    rng = np.random.RandomState(n)
    b, m, k = 2, 96, 16
    assert tk._pick_window(n) == w == pk._pick_window(n)
    xyz = torch.from_numpy(_cloud(rng, b, n))
    new_xyz = torch.from_numpy(_cloud(rng, b, m))
    args = tk.sorted_windows(new_xyz, xyz, w, radius=1.0)["args"]
    _assert_keys_match_pallas(args, w, k, b)


@pytest.mark.parametrize("k", [1, 3, 256])
def test_plain_window_function_matches_pallas_interpret_at_k(k):
    """The selection's edge cases: one key, the three-NN k, and k = w / 4
    (the largest ``nearest_k`` takes, which the card serves with its
    k-round kernel)."""
    rng = np.random.RandomState(k)
    b, m, n, w = 2, 64, 2048, 1024
    xyz = torch.from_numpy(_cloud(rng, b, n))
    new_xyz = torch.from_numpy(_cloud(rng, b, m))
    args = tk.sorted_windows(new_xyz, xyz, w, radius=1.0)["args"]
    got = _assert_keys_match_pallas(args, w, k, b)
    assert k != w // 4 or k > tk.SELECT_MAX_K


def test_plain_window_function_matches_pallas_interpret_on_duplicates():
    """A window of many duplicate points (each point eight times): keys of
    one point's copies differ only in their index bits, where a warp
    selection that compares or drops equal distances goes wrong."""
    rng = np.random.RandomState(8)
    b, m, n, w, k = 2, 64, 1024, 512, 32
    xyz = np.repeat(_cloud(rng, b, n // 8), 8, axis=1)
    new_xyz = xyz[:, rng.choice(n, m, replace=False), :].copy()
    args = tk.sorted_windows(torch.from_numpy(new_xyz), torch.from_numpy(xyz), w, 1.0)["args"]
    got = _assert_keys_match_pallas(args, w, k, b)
    d2_bits = got & ~(w - 1)
    # where the window holds the query's point, its eight copies come first
    assert ((d2_bits[:, :8] == 0).all(axis=1)).mean() > 0.5
    assert (np.diff(d2_bits, axis=1) == 0).mean() > 0.5  # mostly index-bit ties


def _jax_nearest(new_xyz, xyz, k, radius):
    td2, idx, ok = pk.nearest_k(jnp.asarray(new_xyz), jnp.asarray(xyz), k, radius=radius)
    return np.asarray(td2), np.asarray(idx), bool(ok)


def _assert_same_neighbours(td2, idx, j_td2, j_idx):
    """Exact d² within rtol 1e-6 where the neighbours agree; where they
    differ, a quantum tie: the two d² within 2^-11 relative."""
    same = idx == j_idx
    assert same.mean() >= 0.999, f"{(~same).sum()} of {same.size} neighbours differ"
    np.testing.assert_allclose(td2[same], j_td2[same], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(td2[~same], j_td2[~same], rtol=QUANTUM, atol=1e-7)


@pytest.mark.parametrize("b,m,n,k,radius", [
    (2, 512, 4096, 16, 1.0),   # radius mode, W = 1024
    (1, 1024, 8192, 32, 0.5),  # radius mode, W = 2048
    (2, 1024, 2048, 3, None),  # three-NN mode, W = 1024
])
def test_nearest_k_matches_jax(b, m, n, k, radius):
    rng = np.random.RandomState(m + n)
    xyz = _cloud(rng, b, n)
    if radius is None:
        new_xyz = _cloud(rng, b, m)
    else:
        new_xyz = xyz[:, rng.choice(n, m, replace=False), :]
    td2, idx, ok = tk.nearest_k(torch.from_numpy(new_xyz), torch.from_numpy(xyz), k,
                                radius=radius)
    j_td2, j_idx, j_ok = _jax_nearest(new_xyz, xyz, k, radius)
    assert bool(ok) == j_ok
    assert td2.dtype == torch.float32 and idx.dtype == torch.int64
    assert td2.shape == idx.shape == (b, m, k)
    td2, idx = td2.numpy(), idx.numpy()
    _assert_same_neighbours(td2, idx, j_td2, j_idx)
    assert np.all(np.diff(td2, axis=-1) >= 0)
    # the returned d² is the winners' exact float32 diff-form distance
    nbr = np.take_along_axis(xyz, idx.reshape(b, m * k, 1), axis=1).reshape(b, m, k, 3)
    np.testing.assert_allclose(td2, _exact_d2(new_xyz[:, :, None, :], nbr), rtol=1e-6, atol=1e-7)


def test_duplicate_x_keeps_the_stable_tie_order():
    """Queries and candidates on a coarse x grid (many equal x): both sorts
    must be stable, and every chunk must map its winners through its own
    window start (an element repeat of the starts, not a tiling)."""
    rng = np.random.RandomState(7)
    b, m, n, k = 2, 256, 2048, 8
    xyz = _cloud(rng, b, n)
    xyz[..., 0] = np.round(xyz[..., 0] / 4.0) * 4.0
    new_xyz = xyz[:, rng.choice(n, m, replace=False), :].copy()
    new_xyz[..., 1:] += rng.uniform(-0.3, 0.3, (b, m, 2)).astype(np.float32)
    for radius in (2.0, None):
        td2, idx, ok = tk.nearest_k(torch.from_numpy(new_xyz), torch.from_numpy(xyz), k,
                                    radius=radius)
        j_td2, j_idx, j_ok = _jax_nearest(new_xyz, xyz, k, radius)
        assert bool(ok) == j_ok
        _assert_same_neighbours(td2.numpy(), idx.numpy(), j_td2, j_idx)
    s = tk.sorted_windows(torch.from_numpy(new_xyz), torch.from_numpy(xyz), 1024, 2.0)
    j_perm = np.argsort(xyz[..., 0], axis=-1, kind="stable")
    np.testing.assert_array_equal(s["perm"].numpy(), j_perm)
    assert len(np.unique(s["start"].numpy())) > 1  # the chunks' windows differ


def test_dense_fallback_wiring():
    """The pile-up cloud of tests/test_pallas_knn.py: nearly all points in
    one 10 cm x-slab, so no window covers a chunk + radius. The certificate
    fails in both packages and nearest_k returns dense_fn's answer."""
    rng = np.random.RandomState(2)
    b, n, m, k = 1, 1024, 128, 8
    xyz = np.zeros((b, n, 3), np.float32)
    xyz[..., 0] = 40.0 + rng.uniform(-0.05, 0.05, (b, n))
    xyz[..., 1] = rng.uniform(-40, 40, (b, n))
    queries = xyz[:, :m, :].copy()
    q, c = torch.from_numpy(queries), torch.from_numpy(xyz)

    _, _, ok = tk.nearest_k(q, c, k, radius=30.0)
    _, _, j_ok = _jax_nearest(queries, xyz, k, 30.0)
    assert not bool(ok) and not j_ok

    marker = (torch.full((b, m, k), -123.0), torch.zeros((b, m, k), dtype=torch.int64))
    calls = []

    def dense(qq, cc, kk):
        calls.append((qq.shape, cc.shape, kk))
        return marker

    before = tk.nearest_k.dense_fallbacks
    td2, idx = tk.nearest_k(q, c, k, radius=30.0, dense_fn=dense)
    assert td2 is marker[0] and idx is marker[1]
    assert calls == [((b, m, 3), (b, n, 3), k)]
    assert tk.nearest_k.dense_fallbacks == before + 1

    # a certified call answers from the windows and counts no fallback
    good = _cloud(rng, 1, 2048)
    gq = torch.from_numpy(good[:, :256].copy())
    td2, idx = tk.nearest_k(gq, torch.from_numpy(good), 4, radius=1.0, dense_fn=dense)
    assert len(calls) == 1 and tk.nearest_k.dense_fallbacks == before + 1
    w_td2, w_idx, ok = tk.nearest_k(gq, torch.from_numpy(good), 4, radius=1.0)
    assert bool(ok) and torch.equal(td2, w_td2) and torch.equal(idx, w_idx)


@pytest.mark.parametrize("m,n,k", [
    (100, 4096, 8),   # m % 32
    (128, 4000, 8),   # n % 128
    (128, 768, 8),    # n < 2w (w = 512)
    (128, 2048, 0),   # k = 0
    (128, 2048, 257),  # k > w / 4 (w = 1024)
    (128, 3072, 16),  # supported
])
def test_knn_supported_rules_match_jax(m, n, k):
    assert tk.knn_supported(m, n, k) == pk.knn_supported(m, n, k)
    if not tk.knn_supported(m, n, k):
        with pytest.raises(ValueError, match="unsupported shapes"):
            tk.nearest_k(torch.zeros(1, m, 3), torch.zeros(1, n, 3), k)


def test_nearest_topk_matches_jax_with_ties():
    rng = np.random.RandomState(4)
    d2 = np.round(rng.uniform(0, 4, (3, 40, 300)), 1).astype(np.float32)  # many equal values
    for k in (1, 7, 300, 400):
        td2, tidx = nearest_topk(torch.from_numpy(d2), k)
        jd2, jidx = jp2.nearest_topk(jnp.asarray(d2), k)
        assert tidx.dtype == torch.int64
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(td2.numpy(), np.asarray(jd2))


def test_dispatch_on_cpu_is_plain_and_cuda_wrapper_refuses_cpu():
    rng = np.random.RandomState(5)
    xyz = torch.from_numpy(_cloud(rng, 1, 1024))
    args = tk.sorted_windows(xyz[:, :64].contiguous(), xyz, 512, 1.0)["args"]
    before = dict(tk.knn_windows_cuda.launches)
    np.testing.assert_array_equal(tk.knn_windows(*args, w=512, k=8).numpy(),
                                  tk.knn_windows_plain(*args, w=512, k=8).numpy())
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.knn_windows_cuda(*args, w=512, k=8)
    with pytest.raises(ValueError, match="w in"):
        tk.knn_windows_plain(*args, w=256, k=8)
    assert tk.knn_windows_cuda.launches == before


@pytest.mark.parametrize("row", [-1, 5, 13])
def test_windows_outside_their_frame_are_refused(row):
    """Two frames of 1024 candidates (8 rows each), W = 512 (4 rows): a
    window of the second frame must start in rows [8, 12]."""
    rng = np.random.RandomState(6)
    xyz = torch.from_numpy(_cloud(rng, 2, 1024))
    args = list(tk.sorted_windows(xyz[:, :64].contiguous(), xyz, 512, 1.0)["args"])
    lo = args[-1].clone()
    lo[-1] = row
    with pytest.raises(ValueError, match="inside its frame"):
        tk.knn_windows_plain(*args[:-1], lo, w=512, k=8, frames=2)


def test_the_bench_tool_runs_on_the_cpu_at_a_small_size():
    """tools/knn_bench.py's per-shape run on the CPU at a small size, in both
    modes. Radius mode certifies and matches the dense exact path on every
    slot; three-NN queries drawn apart from the candidates leave the
    Lyft-like cloud's sparse far field uncovered, so the certificate fails
    and nearest_k falls back once. No time is reported off the card."""
    rng = np.random.RandomState(9)
    for m, n, k, radius in ((256, 1024, 8, 1.0), (512, 1024, 3, None)):
        xyz = knn_bench.make_cloud(rng, 2, n)
        new_xyz = xyz[:, rng.choice(n, m), :] if radius else knn_bench.make_cloud(rng, 2, m)
        case = {"tag": "small", "m": m, "n": n, "k": k, "radius": radius, "xyz": xyz,
                "new_xyz": new_xyz}
        row = knn_bench.run_case(case, torch.device("cpu"), iters=1)
        assert row["certificate"] == (radius is not None)
        assert row["dense_fallbacks"] == (0 if row["certificate"] else 1)
        if row["certificate"]:
            assert row["slot_match_pct"] == 100.0
        assert row["windowed_ms"] is None and row["dense_ms"] is None
    assert [s[1:] for s in knn_bench.SHAPES] == [
        (4096, 12288, 32, 0.5), (1024, 4096, 32, 1.0), (12288, 4096, 3, None),
        (4096, 1024, 3, None)]
    assert all(tk.knn_supported(m, n, k) for _, m, n, k, _ in knn_bench.SHAPES)
