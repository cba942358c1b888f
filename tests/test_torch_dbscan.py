"""DBSCAN over a kNN graph in the PyTorch port vs the JAX package.

On the same batched (B, N, k) idx/d2/pp/valid, the port's plain edge +
propagation twins (what a CPU tensor runs, and what the CUDA kernels in
modest_tpu_torch/csrc/dbscan.cu are held to on the card) must give the same
raw labels and core flags as the XLA formulation
(``clustering._cluster_from_knn_batch``) and the Pallas kernels in interpret
mode, bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modest_tpu.ops import pallas_dbscan as PD
from modest_tpu.pipeline import clustering as C
from modest_tpu_torch.ops import dbscan as TD

RADIUS, EPS, MIN_SAMPLES = 2.0, 0.1, 10
R2, EPS32 = np.float32(RADIUS * RADIUS), np.float32(EPS)


def _make_frame(rng, n, n_pad):
    """Six Gaussian blobs plus uniform clutter, x-sorted and padded like
    clustering._dbscan_prep; half the points in a tight PP band."""
    centers = rng.uniform(-30, 30, size=(6, 3))
    pts = np.concatenate([c + rng.normal(scale=0.5, size=(n // 8, 3)) for c in centers]
                         + [rng.uniform(-35, 35, size=(n - 6 * (n // 8), 3))])
    pp = rng.uniform(0, 1, n).astype(np.float32)
    pp[: n // 2] *= 0.05
    order = np.argsort(pts[:, 0], kind="stable")
    x = np.zeros((n_pad, 3), np.float32)
    x[:n] = pts[order]
    x[n:, 0] = 1e6 + np.arange(n_pad - n) * max(4.0, 2.1 * RADIUS)
    p = np.zeros(n_pad, np.float32)
    p[:n] = pp[order]
    valid = np.zeros(n_pad, bool)
    valid[:n] = True
    return x, p, valid


def _port(idx, d2, pp, valid, min_samples=MIN_SAMPLES):
    raw, core = TD.dbscan_from_knn(torch.from_numpy(np.asarray(idx, np.int32)),
                                   torch.from_numpy(np.asarray(d2, np.float32)),
                                   torch.from_numpy(np.asarray(pp, np.float32)),
                                   torch.from_numpy(np.asarray(valid, bool)),
                                   float(R2), float(EPS32), min_samples)
    assert raw.dtype == torch.int64 and core.dtype == torch.bool
    return raw.numpy(), core.numpy()


@pytest.mark.parametrize("b,n,n_pad,k", [(1, 1900, 2048, 48), (2, 3000, 3072, 48),
                                         (2, 2900, 3072, 70)])
def test_plain_equals_xla_and_pallas_interpret(b, n, n_pad, k):
    rng = np.random.RandomState(k + b)
    frames = [_make_frame(rng, n - 37 * i, n_pad) for i in range(b)]
    xb = jnp.asarray(np.stack([f[0] for f in frames]))
    ppb = np.stack([f[1] for f in frames])
    vb = np.stack([f[2] for f in frames])
    idx, d2 = C._knn_batch(xb, jnp.asarray(vb), k, row_chunk=1024)
    idx, d2 = np.asarray(idx), np.asarray(d2)

    raw, core = _port(idx, d2, ppb, vb)

    x_raw, x_core = C._cluster_from_knn_batch(jnp.asarray(idx), jnp.asarray(d2), jnp.asarray(ppb),
                                              jnp.asarray(vb), R2, EPS32, MIN_SAMPLES)
    np.testing.assert_array_equal(raw, np.asarray(x_raw))
    np.testing.assert_array_equal(core, np.asarray(x_core))

    los, ws = zip(*(PD.window_rows(f[0][:, 0], n_pad, RADIUS) for f in frames))
    w = max(ws)
    lob = np.minimum(np.stack(los), n_pad // 128 - w // 128)
    packed = np.asarray(PD._dbscan_device(
        jnp.asarray(ppb), jnp.asarray(vb), jnp.asarray(lob), jnp.asarray(idx), jnp.asarray(d2),
        n_pad=n_pad, w=w, min_samples=MIN_SAMPLES, eps=EPS32, radius2=R2, rounds=12,
        interpret=True))
    assert not (packed.flat[0] & 1), "the Pallas round budget was too small for this frame"
    labels = packed >> 2
    np.testing.assert_array_equal(raw, np.where(labels >= n_pad, -1, labels))
    np.testing.assert_array_equal(core, ((packed >> 1) & 1).astype(bool))
    assert (raw >= 0).mean() > 0.2 and core.any()  # the frames really cluster


def test_edge_stage_matches_jax_edge_graph():
    """The edge twin's neighbour rows are exactly JAX's gated edges."""
    rng = np.random.RandomState(4)
    x, p, v = _make_frame(rng, 1500, 2048)
    idx, d2 = C._knn(jnp.asarray(x), jnp.asarray(v), 30, row_chunk=1024)
    idx, d2 = np.asarray(idx), np.asarray(d2)
    graph = TD.dbscan_edge_plain(torch.from_numpy(idx)[None], torch.from_numpy(d2)[None],
                                 torch.from_numpy(p)[None], torch.from_numpy(v)[None],
                                 float(R2), float(EPS32), MIN_SAMPLES)
    kth = np.where(v, np.max(np.where(np.isfinite(d2), d2, -1.0), axis=1), -1.0)
    fin = np.isfinite(d2)
    edge = fin & (d2 <= kth[idx]) & (d2 <= R2) & (np.abs(p[:, None] - p[idx]) <= EPS32)
    np.testing.assert_array_equal(graph.nbr.numpy(), np.where(edge, idx, -1))
    np.testing.assert_array_equal(graph.core.numpy()[0], v & (edge.sum(1) + 1 >= MIN_SAMPLES))


def test_long_chain_needs_many_sweeps_and_converges():
    """Points on a line 1 m apart with shuffled indices: each is linked to
    its two line neighbours only, so the smallest index spreads slowly; the
    port's host loop runs past the Pallas path's 12-round budget and lands
    on the XLA formulation's labels."""
    rng = np.random.RandomState(0)
    n, k = 3000, 2
    perm = rng.permutation(n)  # perm[pos] = index of the point at line position pos
    pos = np.argsort(perm)
    idx = np.zeros((n, k), np.int32)
    d2 = np.ones((n, k), np.float32)
    left, right = pos - 1, pos + 1
    idx[:, 0] = perm[np.clip(left, 0, n - 1)]
    idx[:, 1] = perm[np.clip(right, 0, n - 1)]
    d2[left < 0, 0] = np.inf
    d2[right >= n, 1] = np.inf
    pp = np.zeros(n, np.float32)
    valid = np.ones(n, bool)
    # break the chain in two at position 1500
    d2[pos == 1499, 1] = np.inf
    d2[pos == 1500, 0] = np.inf

    before = TD.dbscan_prop_plain.sweeps
    raw, core = _port(idx[None], d2[None], pp[None], valid[None], min_samples=2)
    assert TD.dbscan_prop_plain.sweeps - before > 12
    x_raw, x_core = C._cluster_from_knn(jnp.asarray(idx), jnp.asarray(d2), jnp.asarray(pp),
                                        jnp.asarray(valid), R2, EPS32, 2)
    np.testing.assert_array_equal(raw[0], np.asarray(x_raw))
    np.testing.assert_array_equal(core[0], np.asarray(x_core))
    assert len(np.unique(raw)) == 2
    assert raw[0, perm[0]] == perm[:1500].min() and raw[0, perm[-1]] == perm[1500:].min()


def test_cuda_wrappers_refuse_cpu_tensors():
    idx = torch.zeros((1, 8, 2), dtype=torch.int32)
    d2 = torch.zeros((1, 8, 2))
    pp = torch.zeros((1, 8))
    valid = torch.ones((1, 8), dtype=torch.bool)
    before = (TD.dbscan_edge_cuda.launches, TD.dbscan_prop_cuda.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        TD.dbscan_edge_cuda(idx, d2, pp, valid, 4.0, 0.1, 10)
    with pytest.raises(ValueError, match="dbscan_edge_cuda"):
        TD.dbscan_prop_cuda(TD.dbscan_edge_plain(idx, d2, pp, valid, 4.0, 0.1, 10))
    with pytest.raises(ValueError, match="int32 idx"):
        TD.dbscan_from_knn(idx.long(), d2, pp, valid, 4.0, 0.1, 10)
    assert (TD.dbscan_edge_cuda.launches, TD.dbscan_prop_cuda.launches) == before
