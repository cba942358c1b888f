"""PP-gated DBSCAN over a batched kNN graph: the CUDA kernels and their plain twins.

Port of ``modest_tpu/ops/pallas_dbscan.py::dbscan_device_impl``. Input: B
frames of N points with their kNN graph, ``idx``/``d2`` (B, N, k)
(frame-local indices, ``inf`` on empty slots), ``pp`` (B, N) and ``valid``
(B, N). Output, the contract of ``clustering.py::_labels_via_pallas``: raw
labels (B, N) int64, the smallest core index of each point's cluster
(frame-local, -1 for noise), and the core flags (B, N) bool.

Two stages, each a kernel with a plain twin here:

* edge — slot s of point i is an edge to j = idx[i, s] when d² is finite,
  d² ≤ r², d² ≤ kth²(j) (mutual kNN) and |pp_i − pp_j| ≤ eps, in float32;
  core = valid ∧ degree + 1 ≥ min_samples. Output: ``nbr`` (B·N, k) int32
  global rows (-1 where no edge) and ``core``.
* prop — min-label propagation over core–core edges with pointer jumping
  to the fixpoint, then border points take the smallest label of a core
  edge neighbour.

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
MAX_SWEEPS = 4096

_COUNT_LOCK = threading.Lock()


@functools.cache
def _lib():
    lib = load_library("dbscan")
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ip = ctypes.POINTER(i)
    lib.dbscan_edge_launch.argtypes = [vp] * 9 + [i, i, i, f, f, i, vp, ip]
    lib.dbscan_edge_launch.restype = i
    lib.dbscan_prop_launch.argtypes = [vp] * 6 + [i, i, i, i, ip, ip, ip, vp]
    lib.dbscan_prop_launch.restype = i
    lib.dbscan_error_string.argtypes = [i]
    lib.dbscan_error_string.restype = ctypes.c_char_p
    for fn in (lib.dbscan_sentinel, lib.dbscan_rounds_per_sync):
        fn.argtypes = []
        fn.restype = i
    if lib.dbscan_sentinel() != SENT:
        raise RuntimeError("csrc/dbscan.cu's sentinel differs from ops/dbscan.py")
    return lib


@dataclass
class EdgeGraph:
    """What the edge stage hands to the propagation stage."""
    nbr: torch.Tensor    # (B·N, k) int32 global neighbour index, -1 where no edge
    core: torch.Tensor   # (B, N) bool
    valid: torch.Tensor  # (B, N) bool
    lab: torch.Tensor | None = None    # (B·N,) int32 initial labels (kernel route)
    flags: torch.Tensor | None = None  # (1 + rounds per sync,) int32 scratch (kernel route)


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
    return EdgeGraph(nbr=nbr, core=core, valid=valid)


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
    (the first host read of the kernels' flags)."""
    check_cuda("dbscan_edge_cuda", {"idx": idx, "d2": d2, "pp": pp, "valid": valid})
    _check(idx, d2, pp, valid, "dbscan_edge_cuda")
    b, n, k = idx.shape
    total = b * n
    if total * 32 >= 2**31 or total * k >= 2**31 or total >= SENT:
        raise ValueError(f"dbscan_edge_cuda: B·N = {total} points with k = {k} is too large")
    lib = _lib()
    dev = idx.device
    kth = torch.empty(total, dtype=torch.float32, device=dev)
    nbr = torch.empty((total, k), dtype=torch.int32, device=dev)
    core = torch.empty((b, n), dtype=torch.bool, device=dev)
    lab = torch.empty(total, dtype=torch.int32, device=dev)
    flags = torch.empty(1 + lib.dbscan_rounds_per_sync(), dtype=torch.int32, device=dev)
    kernels = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = lib.dbscan_edge_launch(idx.data_ptr(), d2.data_ptr(), pp.data_ptr(),
                                     valid.data_ptr(), kth.data_ptr(), nbr.data_ptr(),
                                     core.data_ptr(), lab.data_ptr(), flags.data_ptr(), total, n,
                                     k, float(radius2), float(eps), int(min_samples), _stream(idx),
                                     ctypes.byref(kernels))
    with _COUNT_LOCK:  # pipeline threads launch concurrently
        dbscan_edge_cuda.launches += kernels.value
        dbscan_edge_cuda.calls += 1
    if err != 0:
        raise RuntimeError(f"dbscan edge kernel launch failed: "
                           f"{lib.dbscan_error_string(err).decode()}")
    return EdgeGraph(nbr=nbr, core=core, valid=valid, lab=lab, flags=flags)


dbscan_edge_cuda.launches = 0  # kernels launched (kth + edge per call)
dbscan_edge_cuda.calls = 0     # wrapper calls that launched them


def dbscan_prop_cuda(graph: EdgeGraph) -> torch.Tensor:
    """``dbscan_prop_plain`` by the kernels in ``csrc/dbscan.cu``, on a
    graph from ``dbscan_edge_cuda``. Synchronises once per few sweeps to
    read the fixpoint flags. Counts the kernels it launches (``.launches``:
    a sweep and a pointer jump per sweep, then the border kernel), its calls,
    sweeps and host reads."""
    if graph.lab is None or not graph.nbr.is_cuda:
        raise ValueError("dbscan_prop_cuda needs a graph from dbscan_edge_cuda")
    b, n = graph.core.shape
    k = graph.nbr.shape[1]
    lib = _lib()
    out = torch.empty((b, n), dtype=torch.int32, device=graph.nbr.device)
    lab = graph.lab.clone()  # relabelled in place; the graph stays reusable
    sweeps, kernels, reads = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(graph.nbr.device):
        err = lib.dbscan_prop_launch(graph.nbr.data_ptr(), lab.data_ptr(),
                                     graph.core.data_ptr(), graph.valid.data_ptr(),
                                     out.data_ptr(), graph.flags.data_ptr(), b * n, n, k,
                                     MAX_SWEEPS, ctypes.byref(sweeps), ctypes.byref(kernels),
                                     ctypes.byref(reads), _stream(graph.nbr))
    with _COUNT_LOCK:  # pipeline threads launch concurrently
        dbscan_prop_cuda.launches += kernels.value
        dbscan_prop_cuda.calls += 1
        dbscan_prop_cuda.sweeps += sweeps.value
        dbscan_prop_cuda.host_reads += reads.value
    if err != 0:
        raise RuntimeError(f"dbscan propagation failed: {lib.dbscan_error_string(err).decode()}")
    return out.long()


dbscan_prop_cuda.launches = 0    # kernels launched (2 per sweep + border per call)
dbscan_prop_cuda.calls = 0       # wrapper calls that launched them
dbscan_prop_cuda.sweeps = 0      # sweeps those calls ran
dbscan_prop_cuda.host_reads = 0  # host reads of the fixpoint flags


def dbscan_from_knn(idx, d2, pp, valid, radius2: float, eps: float, min_samples: int):
    """(raw labels (B, N) int64, core (B, N) bool): the plain twins on CPU
    tensors, the kernels on CUDA tensors."""
    if idx.is_cuda:
        graph = dbscan_edge_cuda(idx, d2, pp, valid, radius2, eps, min_samples)
        return dbscan_prop_cuda(graph), graph.core
    graph = dbscan_edge_plain(idx, d2, pp, valid, radius2, eps, min_samples)
    return dbscan_prop_plain(graph), graph.core
