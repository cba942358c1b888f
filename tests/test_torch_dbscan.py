"""DBSCAN over a kNN graph in the PyTorch port vs the JAX package.

On the same batched (B, N, k) idx/d2/pp/valid, the port's plain edge +
propagation twins (what a CPU tensor runs, and what the CUDA kernels in
modest_tpu_torch/csrc/dbscan.cu are held to on the card) must give the same
raw labels and core flags as the XLA formulation
(``clustering._cluster_from_knn_batch``) and the Pallas kernels in interpret
mode, bit for bit; and the plain model of the kernels' propagation
(union-find over two-way edges, a directed fix-up over tie edges) must equal
the sweep twin, on graphs whose one-way tie edges make the directed
fixpoint differ from the undirected components.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modest_tpu.ops import pallas_dbscan as PD
from modest_tpu.pipeline import clustering as C
from modest_tpu_torch.ops import dbscan as TD
from modest_tpu_torch.tools.tie_graph import tie_chain_graph
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

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


@pytest.mark.parametrize("n,n_pad,k", [(1500, 2048, 30),
                                         # the edge kernel's tiles: rows not a multiple of 4,
                                         # k around the tie word's 32 bits
                                         (1493, 1999, 1), (1493, 1999, 31), (1493, 1999, 32),
                                         (1493, 1999, 33), (1493, 1999, 70)])
def test_edge_stage_matches_jax_edge_graph(n, n_pad, k):
    """The edge twin's neighbour rows are exactly JAX's gated edges, and its
    tie words mark the edges with d² = kth²(j) and leave the bits past k
    clear; on frames with pad rows, invalid rows among the points and rows
    whose every slot is empty."""
    rng = np.random.RandomState(4 + k)
    x, p, v = _make_frame(rng, n, n_pad)
    v[rng.choice(n, 9, replace=False)] = False  # invalid rows among the points
    idx, d2 = C._knn(jnp.asarray(x), jnp.asarray(v), k, row_chunk=n_pad)
    idx, d2 = np.array(idx), np.array(d2)
    d2[rng.choice(n, 9, replace=False)] = np.inf  # rows of empty slots only
    graph = TD.dbscan_edge_plain(torch.from_numpy(idx)[None], torch.from_numpy(d2)[None],
                                 torch.from_numpy(p)[None], torch.from_numpy(v)[None],
                                 float(R2), float(EPS32), MIN_SAMPLES)
    kth = np.where(v, np.max(np.where(np.isfinite(d2), d2, -1.0), axis=1), -1.0)
    fin = np.isfinite(d2)
    edge = fin & (d2 <= kth[idx]) & (d2 <= R2) & (np.abs(p[:, None] - p[idx]) <= EPS32)
    np.testing.assert_array_equal(graph.nbr.numpy(), np.where(edge, idx, -1))
    np.testing.assert_array_equal(graph.core.numpy()[0], v & (edge.sum(1) + 1 >= MIN_SAMPLES))
    np.testing.assert_array_equal(TD.unpack_bits(graph.tie, k).numpy(),
                                  edge & (d2 == kth[idx]))
    assert graph.tie.shape == (n_pad, (k + 31) // 32)
    high = graph.tie[:, -1].numpy().view(np.uint32) >> np.uint32(k % 32) if k % 32 else 0
    assert not np.any(high), "bits past k in the last tie word"
    assert edge.any() and (~fin).all(axis=1).sum() >= 9


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


def _graph(idx, d2, pp, valid, min_samples=MIN_SAMPLES):
    return TD.dbscan_edge_plain(torch.from_numpy(np.asarray(idx, np.int32)),
                                torch.from_numpy(np.asarray(d2, np.float32)),
                                torch.from_numpy(np.asarray(pp, np.float32)),
                                torch.from_numpy(np.asarray(valid, bool)),
                                float(R2), float(EPS32), min_samples)


def _undirected_labels(graph):
    """Core labels as the minimum of each undirected core–core component,
    the answer a union-find over every edge would give."""
    b, n = graph.core.shape
    total, k = graph.nbr.shape
    nbr, core = graph.nbr.long(), graph.core.reshape(-1)
    i = torch.arange(total)[:, None].expand(total, k)
    cc = (nbr >= 0) & core[:, None] & core[nbr.clamp_min(0)]
    comp = TD._component_min(i[cc], nbr[cc], torch.arange(total)).reshape(b, n)
    return (comp - (torch.arange(b) * n)[:, None]).numpy()


@pytest.mark.parametrize("b,n,k,min_samples", [(2, 1024, 8, 4), (1, 1024, 16, 6)])
def test_one_way_tie_edges_follow_the_directed_fixpoint(b, n, k, min_samples):
    """Blocks chained by one-way tie edges (tools/tie_graph.py): the labels
    are the smallest index reachable over directed row edges, which differs
    from the undirected component minimum; the plain twin, the XLA
    formulation, the Pallas kernels in interpret mode (one window over the
    whole frame) and the union-find + fix-up model agree bit for bit."""
    idx, d2, pp, valid = tie_chain_graph(b, n, k, seed=k)
    graph = _graph(idx, d2, pp, valid, min_samples)
    raw = TD.dbscan_prop_plain(graph).numpy()
    core = graph.core.numpy()
    assert core.sum() > 0.9 * valid.sum()
    und = _undirected_labels(graph)
    assert (raw[core] != und[core]).sum() > 0.1 * core.sum()

    x_raw, x_core = C._cluster_from_knn_batch(jnp.asarray(idx), jnp.asarray(d2), jnp.asarray(pp),
                                              jnp.asarray(valid), R2, EPS32, min_samples)
    np.testing.assert_array_equal(raw, np.asarray(x_raw))
    np.testing.assert_array_equal(core, np.asarray(x_core))

    packed = np.asarray(PD._dbscan_device(
        jnp.asarray(pp), jnp.asarray(valid), jnp.zeros((b, n // 1024), jnp.int32),
        jnp.asarray(idx), jnp.asarray(d2), n_pad=n, w=n, min_samples=min_samples, eps=EPS32,
        radius2=R2, rounds=24, interpret=True))
    assert not (packed.flat[0] & 1), "the Pallas round budget was too small for this graph"
    labels = packed >> 2
    np.testing.assert_array_equal(raw, np.where(labels >= n, -1, labels))

    comp_raw, pairs, rounds = TD.dbscan_prop_components_plain(graph)
    np.testing.assert_array_equal(comp_raw.numpy(), raw)
    assert len(pairs) > 0 and rounds > 2


@pytest.mark.parametrize("seed,n,k", [(11, 1500, 30), (12, 2900, 70)])
def test_edge_classes_on_knn_frames(seed, n, k):
    """On kNN graphs of Gaussian-blob frames: the tie bits mark exactly the
    edges with d² = kth²(j), and every other edge i → j is two-way (i's
    edge lies in j's row)."""
    rng = np.random.RandomState(seed)
    x, p, v = _make_frame(rng, n, 3072)
    idx, d2 = C._knn(jnp.asarray(x), jnp.asarray(v), k, row_chunk=1024)
    idx, d2 = np.asarray(idx), np.asarray(d2)
    graph = _graph(idx[None], d2[None], p[None], v[None])
    tie = TD.unpack_bits(graph.tie, k).numpy()
    nbr = graph.nbr.numpy()
    kth = np.where(v, np.max(np.where(np.isfinite(d2), d2, -1.0), axis=1), -1.0)
    edge = nbr >= 0
    np.testing.assert_array_equal(tie, edge & (d2 == kth[idx]))
    np.testing.assert_array_equal(TD.pack_bits(torch.from_numpy(tie)).numpy(), graph.tie.numpy())
    rows, slots = np.nonzero(edge & ~tie)
    reverse = (nbr[nbr[rows, slots]] == rows[:, None]).any(axis=1)
    assert reverse.all(), f"{(~reverse).sum()} of {len(rows)} two-way edges lack their reverse"
    assert tie.sum() > 0 and len(rows) > 100 * tie.sum() / 10


@pytest.mark.parametrize("case", ["blobs", "tie_chain", "long_chain"])
def test_union_find_model_equals_the_sweeps(case):
    """The kernels' design in plain PyTorch (components of the two-way
    edges, directed fix-up over the tie edges) against the sweep twin, and
    its tie pairs against the core–core tie edges of the graph."""
    rng = np.random.RandomState(5)
    if case == "blobs":
        frames = [_make_frame(rng, 2000 - 37 * i, 2048) for i in range(2)]
        idx, d2 = C._knn_batch(jnp.asarray(np.stack([f[0] for f in frames])),
                               jnp.asarray(np.stack([f[2] for f in frames])), 48, row_chunk=1024)
        args, ms = (np.asarray(idx), np.asarray(d2), np.stack([f[1] for f in frames]),
                    np.stack([f[2] for f in frames])), MIN_SAMPLES
    elif case == "tie_chain":
        args, ms = tie_chain_graph(2, 2048, 24, seed=1), 8
    else:  # every edge a tie: the fix-up does all the work
        n = 600
        perm = rng.permutation(n)
        pos = np.argsort(perm)
        idx = np.stack([perm[np.clip(pos - 1, 0, n - 1)], perm[np.clip(pos + 1, 0, n - 1)]], 1)
        d2 = np.where(np.stack([pos == 0, pos == n - 1], 1), np.inf, 1.0)
        args, ms = (idx[None], d2[None], np.zeros((1, n)), np.ones((1, n), bool)), 2
    graph = _graph(*args, min_samples=ms)
    want = TD.dbscan_prop_plain(graph)
    got, pairs, rounds = TD.dbscan_prop_components_plain(graph)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    k = graph.nbr.shape[1]
    core = graph.core.reshape(-1)
    nbr = graph.nbr.long()
    cc_tie = TD.unpack_bits(graph.tie, k) & (nbr >= 0) & core[:, None] & core[nbr.clamp_min(0)]
    assert len(pairs) == int(cc_tie.sum()) and rounds >= 1
