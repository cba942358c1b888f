"""PP-gated DBSCAN over a batched kNN graph: the CUDA kernels and their plain twins.

Port of ``modest_tpu/ops/pallas_dbscan.py::dbscan_device_impl``. Input: B
frames of N points with their kNN graph, ``idx``/``d2`` (B, N, k)
(frame-local indices, ``inf`` on empty slots), ``pp`` (B, N) and ``valid``
(B, N). Output, the contract of ``clustering.py::_labels_via_pallas``: raw
labels (B, N) int64, the smallest core index reachable from each core point
over directed row edges (frame-local, -1 for noise), and the core flags
(B, N) bool.

Two stages, each a kernel with a plain twin here:

* edge — slot s of point i is an edge to j = idx[i, s] when d² is finite,
  d² ≤ r², d² ≤ kth²(j) (mutual kNN) and |pp_i − pp_j| ≤ eps, in float32;
  core = valid ∧ degree + 1 ≥ min_samples. Output: ``nbr`` (B·N, k) int32
  global rows (-1 where no edge), ``core``, and the edge classes ``tie``
  (B·N, ⌈k/32⌉) int32 bit words: bit s is set when edge s has d² = kth²(j),
  a tie edge, which may be one-way; an edge with d² < kth²(j) is two-way
  when the rows are an exact top-k under one symmetric d² (see
  ``csrc/dbscan.cu``).
* prop — the directed min-label fixpoint over core–core edges, then border
  points take the smallest label of a core edge neighbour. The plain twin
  sweeps with pointer jumping to the fixpoint; the kernels join the two-way
  edges by union-find and run a directed fix-up over the tie edges only.
  ``dbscan_prop_components_plain`` is that design in plain PyTorch.

``dbscan_from_knn`` takes the plain twins for CPU tensors and the kernels
(``csrc/dbscan.cu``) for CUDA tensors.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from dataclasses import dataclass

import torch

from ._build import check_cuda, load_library

SENT = 0x3FFFFFFF  # label of non-core points in the propagation table

_COUNT_LOCK = threading.Lock()


@functools.cache
def _lib():
    lib = load_library("dbscan")
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ip = ctypes.POINTER(i)
    lib.dbscan_edge_launch.argtypes = [vp] * 10 + [i, i, i, f, f, i, vp, ip]
    lib.dbscan_edge_launch.restype = i
    lib.dbscan_prop_launch.argtypes = [vp] * 9 + [i, i, i, ip, ip, ip, ip, vp]
    lib.dbscan_prop_launch.restype = i
    lib.dbscan_error_string.argtypes = [i]
    lib.dbscan_error_string.restype = ctypes.c_char_p
    for fn in (lib.dbscan_sentinel, lib.dbscan_flag_count, lib.dbscan_max_k):
        fn.argtypes = []
        fn.restype = i
    if lib.dbscan_sentinel() != SENT:
        raise RuntimeError("csrc/dbscan.cu's sentinel differs from ops/dbscan.py")
    return lib


@dataclass
class EdgeGraph:
    """What the edge stage hands to the propagation stage."""
    nbr: torch.Tensor    # (B·N, k) int32 global neighbour index, -1 where no edge
    tie: torch.Tensor    # (B·N, ⌈k/32⌉) int32: bit s set where edge s is a tie edge
    core: torch.Tensor   # (B, N) bool
    valid: torch.Tensor  # (B, N) bool
    lab: torch.Tensor | None = None    # (B·N,) int32 initial labels (kernel route)
    flags: torch.Tensor | None = None  # (3,) int32 scratch (kernel route)


def _check(idx, d2, pp, valid, where: str):
    if idx.ndim != 3 or d2.shape != idx.shape:
        raise ValueError(f"{where} needs idx and d2 of one (B, N, k) shape, "
                         f"got {tuple(idx.shape)} and {tuple(d2.shape)}")
    if pp.shape != idx.shape[:2] or valid.shape != idx.shape[:2]:
        raise ValueError(f"{where} needs pp and valid (B, N) = {tuple(idx.shape[:2])}")
    if idx.dtype != torch.int32 or d2.dtype != torch.float32 or pp.dtype != torch.float32 \
            or valid.dtype != torch.bool:
        raise ValueError(f"{where} needs int32 idx, float32 d2 and pp, bool valid; got "
                         f"{idx.dtype}, {d2.dtype}, {pp.dtype}, {valid.dtype}")


# ---------------------------------------------------------------------------
# plain twins (the arithmetic of clustering.py::_cluster_from_knn_impl)
# ---------------------------------------------------------------------------


def dbscan_edge_plain(idx, d2, pp, valid, radius2: float, eps: float,
                      min_samples: int) -> EdgeGraph:
    _check(idx, d2, pp, valid, "dbscan_edge_plain")
    b, n, k = idx.shape
    finite = torch.isfinite(d2)
    kth = torch.where(valid, torch.where(finite, d2, -1.0).amax(dim=2), -1.0).reshape(-1)
    j = (idx.long() + (torch.arange(b, device=idx.device) * n)[:, None, None]).reshape(b * n, k)
    d2f = d2.reshape(b * n, k)
    mutual = finite.reshape(b * n, k) & (d2f <= kth[j])
    within = finite.reshape(b * n, k) & (d2f <= radius2)
    pp_ok = (pp.reshape(-1, 1) - pp.reshape(-1)[j]).abs() <= eps
    edge = mutual & within & pp_ok
    core = valid & ((edge.sum(dim=1).reshape(b, n) + 1) >= min_samples)
    nbr = torch.where(edge, j, -1).to(torch.int32)
    return EdgeGraph(nbr=nbr, tie=pack_bits(edge & ~(d2f < kth[j])), core=core, valid=valid)


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """(R, k) bool → (R, ⌈k/32⌉) int32 words, bit s % 32 of word s // 32."""
    r, k = mask.shape
    words = (k + 31) // 32
    full = torch.zeros((r, words * 32), dtype=torch.int64, device=mask.device)
    full[:, :k] = mask.long()
    packed = (full.reshape(r, words, 32) << torch.arange(32, device=mask.device)).sum(dim=2)
    return torch.where(packed >= 2**31, packed - 2**32, packed).to(torch.int32)


def unpack_bits(words: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of ``pack_bits``: (R, ⌈k/32⌉) int32 → (R, k) bool."""
    s = torch.arange(k, device=words.device)
    return ((words[:, s // 32] >> (s % 32)) & 1).bool()


def dbscan_prop_plain(graph: EdgeGraph) -> torch.Tensor:
    """Host loops of sweeps, each followed by pointer jumping to its own
    fixpoint, until a sweep changes nothing; then border labels. Returns
    (B, N) int64 frame-local labels, -1 for noise."""
    b, n = graph.core.shape
    total = b * n
    core = graph.core.reshape(-1)
    nbr = torch.where(graph.nbr >= 0, graph.nbr.long(), total)  # sentinel slot = total
    lab = torch.where(core, torch.arange(total, device=core.device), total)
    sent = torch.full((1,), total, dtype=lab.dtype, device=lab.device)
    while True:
        dbscan_prop_plain.sweeps += 1
        ext = torch.cat([lab, sent])
        new = torch.where(core, torch.minimum(lab, ext[nbr].amin(dim=1)), lab)
        while True:
            jumped = torch.minimum(new, torch.cat([new, sent])[new])
            if torch.equal(jumped, new):
                break
            new = jumped
        if torch.equal(new, lab):
            break
        lab = new
    border = torch.cat([lab, sent])[nbr].amin(dim=1)
    out = torch.where(core, lab, torch.where(border < total, border, -1))
    out = torch.where(graph.valid.reshape(-1), out, -1).reshape(b, n)
    return torch.where(out >= 0, out - (torch.arange(b, device=out.device) * n)[:, None], -1)


dbscan_prop_plain.sweeps = 0  # sweeps run by all calls


def _component_min(a: torch.Tensor, b: torch.Tensor, lab: torch.Tensor) -> torch.Tensor:
    """Smallest label of each undirected component of the edges (a, b)."""
    while True:
        new = lab.scatter_reduce(0, a, lab[b], "amin").scatter_reduce(0, b, lab[a], "amin")
        while True:  # pointer jumping: a label is a member's index
            jumped = torch.minimum(new, new[new])
            if torch.equal(jumped, new):
                break
            new = jumped
        if torch.equal(new, lab):
            return lab
        lab = new


def dbscan_prop_components_plain(graph: EdgeGraph):
    """The kernels' design in plain PyTorch: components of the two-way
    core–core edges (what the union-find computes), the directed fix-up
    over the core–core tie edges on component labels, then border labels.
    Returns ((B, N) int64 labels equal to ``dbscan_prop_plain``'s, the tie
    pairs (T, 2) int64 as (i, j) global indices, the fix-up's rounds
    including the last one that changes nothing)."""
    b, n = graph.core.shape
    total, k = graph.nbr.shape
    dev = graph.nbr.device
    core = graph.core.reshape(-1)
    nbr = graph.nbr.long()
    i = torch.arange(total, device=dev)[:, None].expand(total, k)
    cc = (nbr >= 0) & core[:, None] & core[nbr.clamp_min(0)]
    tie = unpack_bits(graph.tie, k)
    two_way, ties = cc & ~tie, cc & tie
    comp = _component_min(i[two_way], nbr[two_way], torch.arange(total, device=dev))
    pairs = torch.stack([i[ties], nbr[ties]], dim=1)
    ci, cj = comp[pairs[:, 0]], comp[pairs[:, 1]]
    val = comp.clone()
    rounds = 0
    while True:  # Jacobi rounds: each lowers val[ci] to val[cj] where smaller
        rounds += 1
        new = val.scatter_reduce(0, ci, val[cj], "amin")
        if torch.equal(new, val):
            break
        val = new
    lab = torch.where(core, val[comp], total)
    sent = torch.full((1,), total, dtype=lab.dtype, device=dev)
    border = torch.cat([lab, sent])[torch.where(nbr >= 0, nbr, total)].amin(dim=1)
    out = torch.where(core, lab, torch.where(border < total, border, -1))
    out = torch.where(graph.valid.reshape(-1), out, -1).reshape(b, n)
    out = torch.where(out >= 0, out - (torch.arange(b, device=dev) * n)[:, None], -1)
    return out, pairs, rounds


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def dbscan_edge_cuda(idx, d2, pp, valid, radius2: float, eps: float,
                     min_samples: int) -> EdgeGraph:
    """``dbscan_edge_plain`` by the kernels in ``csrc/dbscan.cu``. Needs
    contiguous CUDA tensors on one device; raises on any other input. A
    neighbour index outside its frame is reported by ``dbscan_prop_cuda``
    (its host read of the kernels' flags)."""
    check_cuda("dbscan_edge_cuda", {"idx": idx, "d2": d2, "pp": pp, "valid": valid})
    _check(idx, d2, pp, valid, "dbscan_edge_cuda")
    b, n, k = idx.shape
    total = b * n
    lib = _lib()
    if total * 32 >= 2**31 or total * k >= 2**31 or total >= SENT or k > lib.dbscan_max_k():
        raise ValueError(f"dbscan_edge_cuda: B·N = {total} points with k = {k} is too large "
                         f"(k <= {lib.dbscan_max_k()})")
    dev = idx.device
    kp = torch.empty((total, 2), dtype=torch.float32, device=dev)  # (kth², pp) per point
    nbr = torch.empty((total, k), dtype=torch.int32, device=dev)
    tie = torch.empty((total, (k + 31) // 32), dtype=torch.int32, device=dev)
    core = torch.empty((b, n), dtype=torch.bool, device=dev)
    lab = torch.empty(total, dtype=torch.int32, device=dev)
    flags = torch.empty(lib.dbscan_flag_count(), dtype=torch.int32, device=dev)
    kernels = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = lib.dbscan_edge_launch(idx.data_ptr(), d2.data_ptr(), pp.data_ptr(),
                                     valid.data_ptr(), kp.data_ptr(), nbr.data_ptr(),
                                     tie.data_ptr(), core.data_ptr(), lab.data_ptr(),
                                     flags.data_ptr(), total, n, k, float(radius2), float(eps),
                                     int(min_samples), _stream(idx), ctypes.byref(kernels))
    with _COUNT_LOCK:  # pipeline threads launch concurrently
        dbscan_edge_cuda.launches += kernels.value
        dbscan_edge_cuda.calls += 1
    if err != 0:
        raise RuntimeError(f"dbscan edge kernel launch failed: "
                           f"{lib.dbscan_error_string(err).decode()}")
    return EdgeGraph(nbr=nbr, tie=tie, core=core, valid=valid, lab=lab, flags=flags)


dbscan_edge_cuda.launches = 0  # kernels launched (kth + edge per call)
dbscan_edge_cuda.calls = 0     # wrapper calls that launched them


def dbscan_prop_cuda(graph: EdgeGraph) -> torch.Tensor:
    """``dbscan_prop_plain`` by the kernels in ``csrc/dbscan.cu`` (init,
    compress, union, flatten, fix-up, border), on a graph from
    ``dbscan_edge_cuda``. Reads the kernels' flags once, at the end. Counts
    the kernels it launches (``.launches``, 6 per call), its calls, the
    fix-up's rounds, the core–core tie edges and the host reads."""
    if graph.lab is None or not graph.nbr.is_cuda:
        raise ValueError("dbscan_prop_cuda needs a graph from dbscan_edge_cuda")
    b, n = graph.core.shape
    total, k = graph.nbr.shape
    lib = _lib()
    dev = graph.nbr.device
    out = torch.empty((b, n), dtype=torch.int32, device=dev)
    parent = graph.lab.clone()  # relabelled in place; the graph stays reusable
    val = torch.empty(total, dtype=torch.int32, device=dev)
    pairs = torch.empty((total * k, 2), dtype=torch.int32, device=dev)  # room for every slot
    rounds, ties, kernels, reads = (ctypes.c_int(0) for _ in range(4))
    with torch.cuda.device(dev):
        err = lib.dbscan_prop_launch(graph.nbr.data_ptr(), graph.tie.data_ptr(),
                                     graph.core.data_ptr(), graph.valid.data_ptr(),
                                     parent.data_ptr(), val.data_ptr(), pairs.data_ptr(),
                                     out.data_ptr(), graph.flags.data_ptr(), total, n, k,
                                     ctypes.byref(rounds), ctypes.byref(ties),
                                     ctypes.byref(kernels), ctypes.byref(reads),
                                     _stream(graph.nbr))
    with _COUNT_LOCK:  # pipeline threads launch concurrently
        dbscan_prop_cuda.launches += kernels.value
        dbscan_prop_cuda.calls += 1
        dbscan_prop_cuda.rounds += rounds.value
        dbscan_prop_cuda.ties += ties.value
        dbscan_prop_cuda.host_reads += reads.value
    if err != 0:
        raise RuntimeError(f"dbscan propagation failed: {lib.dbscan_error_string(err).decode()}")
    return out.long()


dbscan_prop_cuda.launches = 0    # kernels launched (6 per call)
dbscan_prop_cuda.calls = 0       # wrapper calls that launched them
dbscan_prop_cuda.rounds = 0      # fix-up rounds those calls ran
dbscan_prop_cuda.ties = 0        # core–core tie edges the fix-up went over
dbscan_prop_cuda.host_reads = 0  # host reads of the kernels' flags (1 per call)


def dbscan_from_knn(idx, d2, pp, valid, radius2: float, eps: float, min_samples: int):
    """(raw labels (B, N) int64, core (B, N) bool): the plain twins on CPU
    tensors, the kernels on CUDA tensors."""
    if idx.is_cuda:
        graph = dbscan_edge_cuda(idx, d2, pp, valid, radius2, eps, min_samples)
        return dbscan_prop_cuda(graph), graph.core
    graph = dbscan_edge_plain(idx, d2, pp, valid, radius2, eps, min_samples)
    return dbscan_prop_plain(graph), graph.core
