"""Windowed radius count over x-sorted pools: the CUDA kernel and its plain twin.

Port of ``modest_tpu/ops/pallas_radius_count.py``. Queries are x-sorted and
cut into tiles of ``BN`` = 256; each traversal's pool is x-sorted and cut
into tiles of ``BM`` = 2048 points. ``compute_tile_windows`` gives, per
traversal and query tile, the pool tiles ``[lo, hi)`` that can hold a point
within ``radius`` in x; the count then tests ``d² ≤ r²`` (inclusive) with
direct differences, ``((dx*dx + dy*dy) + dz*dz)``, on every point of the
window. Exact: the window is a superset of the true neighbour set.

The kernel cuts every window into chunks of at most ``CHUNK_TILES`` pool
tiles (``split_windows``) and counts each chunk as one work item, so one
long window (the last real query tile, which also holds pad queries, runs
through every pad point of each pool) is spread over the card.

``radius_count_sorted_cuda`` launches ``csrc/radius_count.cu`` on CUDA
tensors; ``radius_count_sorted_plain`` is the same arithmetic in PyTorch;
``radius_count_sorted`` takes the plain twin for CPU tensors and the kernel
for CUDA tensors.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from ._build import check_cuda, load_library

BN = 256   # queries per tile
BM = 2048  # pool points per window tile
PAD = 1e9  # x (and y, z) of pad queries and pad pool points
_PLAIN_CHUNK = 16 * BM  # pool points per step of the plain twin
CHUNK_TILES = 1  # pool tiles per kernel work item (csrc/radius_count.cu's kChunkTiles)

_COUNT_LOCK = threading.Lock()


@functools.cache
def _lib():
    lib = load_library("radius_count")
    lib.radius_count_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.radius_count_launch.restype = ctypes.c_int
    lib.radius_count_error_string.argtypes = [ctypes.c_int]
    lib.radius_count_error_string.restype = ctypes.c_char_p
    sizes = (lib.radius_count_tile_queries, lib.radius_count_tile_points,
             lib.radius_count_chunk_tiles)
    for fn in sizes:
        fn.argtypes = []
        fn.restype = ctypes.c_int
    if tuple(fn() for fn in sizes) != (BN, BM, CHUNK_TILES):
        raise RuntimeError("csrc/radius_count.cu tiles differ from ops/radius_count.py")
    return lib


def compute_tile_windows(q_sorted_x: torch.Tensor, t_sorted_x: torch.Tensor,
                         radius: torch.Tensor) -> torch.Tensor:
    """(T, Nq / BN, 2) int32 pool-tile windows ``[lo, hi)`` per query tile.

    q_sorted_x (Nq,) ascending; t_sorted_x (T, M) ascending per traversal;
    radius a float32 scalar tensor. An empty window is (0, 0)."""
    nq = q_sorted_x.shape[0] // BN
    q_tiles = q_sorted_x.reshape(nq, BN)
    tile_min = q_tiles.min(dim=1).values - radius
    tile_max = q_tiles.max(dim=1).values + radius
    t_count = t_sorted_x.shape[0]
    t_sorted_x = t_sorted_x.contiguous()
    start = torch.searchsorted(t_sorted_x, tile_min.expand(t_count, nq).contiguous(), side="left")
    end = torch.searchsorted(t_sorted_x, tile_max.expand(t_count, nq).contiguous(), side="right")
    lo = torch.div(start, BM, rounding_mode="floor")
    hi = torch.maximum(torch.div(end + BM - 1, BM, rounding_mode="floor"), lo)
    empty = start >= end
    lo = torch.where(empty, 0, lo)
    hi = torch.where(empty, 0, hi)
    return torch.stack([lo, hi], dim=2).to(torch.int32)


def split_windows(lohi: torch.Tensor, chunk_tiles: int = CHUNK_TILES) -> torch.Tensor:
    """The kernel's work list. Window ``w = t * (Nq / BN) + tile`` of
    ``lohi`` (T, Nq / BN, 2) is cut into ``ceil((hi - lo) / chunk_tiles)``
    chunks of at most ``chunk_tiles`` pool tiles (none for an empty window).
    Returns ``starts`` (T * Nq / BN + 1,) int32, the exclusive prefix sum of
    those chunk counts: window w's chunks are the work items ``starts[w]``
    … ``starts[w + 1] - 1``, and ``starts[-1]`` is their number. Made on
    ``lohi``'s device, with no host read."""
    span = (lohi[..., 1] - lohi[..., 0]).clamp_min(0).reshape(-1)
    chunks = torch.div(span + chunk_tiles - 1, chunk_tiles, rounding_mode="floor")
    return torch.cat([chunks.new_zeros(1), torch.cumsum(chunks, 0)]).to(torch.int32)


def _check(q_sorted, t_sorted, lohi, where: str):
    if q_sorted.dtype != torch.float32 or t_sorted.dtype != torch.float32:
        raise ValueError(f"{where} needs float32 queries and pool")
    if lohi.dtype != torch.int32:
        raise ValueError(f"{where} needs int32 windows, got {lohi.dtype}")
    if q_sorted.ndim != 2 or q_sorted.shape[0] != 3 or q_sorted.shape[1] % BN:
        raise ValueError(f"{where} needs queries (3, Nq) with Nq % {BN} == 0, "
                         f"got {tuple(q_sorted.shape)}")
    if t_sorted.ndim != 3 or t_sorted.shape[1] != 3 or t_sorted.shape[2] % BM:
        raise ValueError(f"{where} needs a pool (T, 3, M) with M % {BM} == 0, "
                         f"got {tuple(t_sorted.shape)}")
    t_count, nq = t_sorted.shape[0], q_sorted.shape[1] // BN
    if tuple(lohi.shape) != (t_count, nq, 2):
        raise ValueError(f"{where} needs windows ({t_count}, {nq}, 2), got {tuple(lohi.shape)}")
    # one host read: a window past the pool would read outside it
    if bool(((lohi < 0) | (lohi > t_sorted.shape[2] // BM)).any()):
        raise ValueError(f"{where} needs windows inside [0, M / {BM}] = "
                         f"[0, {t_sorted.shape[2] // BM}]")


def radius_count_sorted_plain(q_sorted: torch.Tensor, t_sorted: torch.Tensor,
                              lohi: torch.Tensor, r2: float) -> torch.Tensor:
    """q_sorted (3, Nq), t_sorted (T, 3, M), lohi (T, Nq / BN, 2) → (T, Nq)
    int32 counts of pool points with ``d² ≤ r2`` in each tile's window."""
    _check(q_sorted, t_sorted, lohi, "radius_count_sorted_plain")
    t_count, nq_total = t_sorted.shape[0], q_sorted.shape[1]
    r2_t = torch.tensor(r2, dtype=torch.float32, device=q_sorted.device)
    counts = torch.zeros((t_count, nq_total), dtype=torch.int32, device=q_sorted.device)
    windows = lohi.cpu().tolist()
    for t in range(t_count):
        for i, (lo, hi) in enumerate(windows[t]):
            if lo >= hi:
                continue
            q = q_sorted[:, i * BN:(i + 1) * BN, None]  # (3, BN, 1)
            acc = torch.zeros(BN, dtype=torch.int64, device=q_sorted.device)
            for a in range(lo * BM, hi * BM, _PLAIN_CHUNK):
                p = t_sorted[t, :, None, a:min(a + _PLAIN_CHUNK, hi * BM)]  # (3, 1, w)
                dx, dy, dz = p[0] - q[0], p[1] - q[1], p[2] - q[2]
                d2 = (dx * dx + dy * dy) + dz * dz
                acc += (d2 <= r2_t).sum(dim=1)
            counts[t, i * BN:(i + 1) * BN] = acc.to(torch.int32)
    return counts


def radius_count_sorted_cuda(q_sorted: torch.Tensor, t_sorted: torch.Tensor,
                             lohi: torch.Tensor, r2: float) -> torch.Tensor:
    """The same as ``radius_count_sorted_plain``, by the kernel in
    ``csrc/radius_count.cu`` over ``split_windows(lohi)``.
    Needs contiguous CUDA tensors on one device; raises on any other
    input."""
    check_cuda("radius_count_sorted_cuda", {"queries": q_sorted, "pool": t_sorted,
                                            "windows": lohi})
    _check(q_sorted, t_sorted, lohi, "radius_count_sorted_cuda")
    t_count, _, m = t_sorted.shape
    nq_total = q_sorted.shape[1]
    if max(t_count * 3 * m, 3 * nq_total, t_count * nq_total) >= 2**31:
        raise ValueError("radius_count_sorted_cuda: tensors above 2^31 elements")
    if t_sorted.data_ptr() % 16:
        raise ValueError("radius_count_sorted_cuda needs a 16-byte aligned pool")
    lib = _lib()
    starts = split_windows(lohi)
    counts = torch.zeros((t_count, nq_total), dtype=torch.int32, device=q_sorted.device)
    with torch.cuda.device(q_sorted.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.radius_count_launch(q_sorted.data_ptr(), t_sorted.data_ptr(), lohi.data_ptr(),
                                      starts.data_ptr(), counts.data_ptr(), t_count, nq_total, m,
                                      float(r2), stream)
    if err != 0:
        raise RuntimeError(f"radius_count kernel launch failed: "
                           f"{lib.radius_count_error_string(err).decode()}")
    with _COUNT_LOCK:  # pipeline threads launch concurrently
        radius_count_sorted_cuda.launches += 1
    return counts


radius_count_sorted_cuda.launches = 0  # kernel launches since the last reset


def radius_count_sorted(q_sorted: torch.Tensor, t_sorted: torch.Tensor, lohi: torch.Tensor,
                        r2: float) -> torch.Tensor:
    """Dispatch: the plain twin for CPU tensors, the kernel for CUDA tensors."""
    if q_sorted.is_cuda:
        return radius_count_sorted_cuda(q_sorted, t_sorted, lohi, r2)
    return radius_count_sorted_plain(q_sorted, t_sorted, lohi, r2)
