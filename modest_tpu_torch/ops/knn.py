"""Windowed k nearest neighbours over x-sorted candidates: the CUDA kernel and its plain twin.

Port of ``modest_tpu/ops/pallas_knn.py``. Candidates are x-sorted per
frame; each chunk of ``QC`` = 32 x-sorted queries scans one window of ``w``
consecutive sorted candidates, starting at a 128-candidate row ``lo`` of its
frame. The window function (``knn_windows``) ranks the window by one int32
key per candidate, ``(d2_bits & ~(w − 1)) | local_index``: the bits of a
non-negative float32 order like its value, so the key ranks by d² quantised
to ~2^-12 relative, with the window-local index in the low bits, and the k
smallest keys are the k winners in ascending order. d² is the direct form
``((dx*dx + dy*dy) + dz*dz)`` in float32.

``nearest_k`` wraps it as the JAX function does: x-sorts, centres each
chunk's window on the span it needs, maps the winners back to the caller's
indices, recomputes their exact d² and re-sorts them, and proves coverage
with a certificate (radius mode: the window holds ``[min x − r, max x + r]``
of its chunk; three-NN mode: no candidate outside the window can beat the
k-th winner). When the certificate fails, ``dense_fn`` answers instead.

``knn_windows_cuda`` launches ``csrc/knn.cu`` on CUDA tensors (a warp
selection over tiles scanned outward from each query for k ≤ 32, the
earlier k-round kernel above);
``knn_windows_plain`` is the same arithmetic in PyTorch; ``knn_windows``
takes the plain twin for CPU tensors and the kernel for CUDA tensors.
Indices are int64, the port's convention (``torch.gather`` takes them).
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from ._build import check_cuda, launch_with_flag, load_library

QC = 32          # queries per chunk: one window each
ROW = 128        # windows start on rows of 128 sorted candidates
WINDOWS = (512, 1024, 2048)
SELECT_MAX_K = 32  # k up to this takes knn_select_kernel, above it knn_rounds_kernel
_PLAIN_ELEMS = 1 << 24  # keys per step of the plain twin (64 MB of int32)

_COUNT_LOCK = threading.Lock()


@functools.cache
def _lib():
    lib = load_library("knn")
    lib.knn_launch.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                               + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
                                  ctypes.c_void_p])
    lib.knn_launch.restype = ctypes.c_int
    lib.knn_error_string.argtypes = [ctypes.c_int]
    lib.knn_error_string.restype = ctypes.c_char_p
    for fn in (lib.knn_queries_per_chunk, lib.knn_select_max_k):
        fn.argtypes = []
        fn.restype = ctypes.c_int
    if lib.knn_queries_per_chunk() != QC or lib.knn_select_max_k() != SELECT_MAX_K:
        raise RuntimeError("csrc/knn.cu's chunk or select limit differs from ops/knn.py")
    return lib


def _pick_window(n: int) -> int:
    """Window width per candidate count: ≥ 8× the average 32-query x-span
    at uniform density, so the certificate holds except in near-field
    pile-ups (which fall back dense)."""
    if n >= 8192:
        return 2048
    if n >= 2048:
        return 1024
    return 512


def knn_supported(m: int, n: int, k: int) -> bool:
    w = _pick_window(n)
    return m % QC == 0 and n % ROW == 0 and n >= 2 * w and 0 < k <= w // 4


def _check(qx, qy, qz, xs, ys, zs, lo, w: int, k: int, frames: int, where: str):
    if any(t.dtype != torch.float32 for t in (qx, qy, qz, xs, ys, zs)) or lo.dtype != torch.int32:
        raise ValueError(f"{where} needs float32 coordinates and int32 window rows")
    bm = qx.shape[0]
    if qx.ndim != 2 or qx.shape[1] != 1 or bm % QC or qy.shape != qx.shape or qz.shape != qx.shape:
        raise ValueError(f"{where} needs queries (B·M, 1) with B·M % {QC} == 0, "
                         f"got {tuple(qx.shape)}, {tuple(qy.shape)}, {tuple(qz.shape)}")
    if xs.ndim != 2 or xs.shape[1] != ROW or ys.shape != xs.shape or zs.shape != xs.shape:
        raise ValueError(f"{where} needs candidates (B·N / {ROW}, {ROW}), got {tuple(xs.shape)}, "
                         f"{tuple(ys.shape)}, {tuple(zs.shape)}")
    nchunk, rows = bm // QC, xs.shape[0]
    if tuple(lo.shape) != (nchunk,):
        raise ValueError(f"{where} needs window rows ({nchunk},), got {tuple(lo.shape)}")
    if w not in WINDOWS or not 0 < k <= w:
        raise ValueError(f"{where} needs w in {WINDOWS} and 0 < k <= w, got w={w} k={k}")
    if frames < 1 or rows % frames or nchunk % frames:
        raise ValueError(f"{where}: {frames} frames do not divide {rows} rows and {nchunk} chunks")


def _outside_message(where: str, w: int, rows_pf: int) -> str:
    return f"{where} needs every window of {w // ROW} rows inside its frame's {rows_pf} rows"


def knn_windows_plain(qx, qy, qz, xs, ys, zs, lo, *, w: int, k: int, frames: int = 1):
    """qx, qy, qz (B·M, 1) x-sorted query coordinates; xs, ys, zs
    (B·N / 128, 128) x-sorted candidate coordinates, frames stacked; lo
    (B·M / 32,) int32 window start rows → (B·M, k) int32 packed keys
    ``(d2_bits & ~(w − 1)) | window_index``, ascending. ``frames`` = B: each
    window must lie in its chunk's frame."""
    _check(qx, qy, qz, xs, ys, zs, lo, w, k, frames, "knn_windows_plain")
    bm, dev = qx.shape[0], qx.device
    nchunk, rows_pf = bm // QC, xs.shape[0] // frames
    # one host read: a window must lie inside its own frame's rows
    first = (torch.arange(nchunk, device=dev) // max(nchunk // frames, 1)) * rows_pf
    if bool(((lo < first) | (lo + w // ROW > first + rows_pf)).any()):
        raise ValueError(_outside_message("knn_windows_plain", w, rows_pf))
    cx, cy, cz = xs.reshape(-1), ys.reshape(-1), zs.reshape(-1)
    lane = torch.arange(w, device=dev)
    out = torch.empty((bm, k), dtype=torch.int32, device=dev)
    step = max(1, _PLAIN_ELEMS // (QC * w))  # chunks per step
    for c0 in range(0, nchunk, step):
        c1 = min(nchunk, c0 + step)
        cols = lo[c0:c1].long()[:, None] * ROW + lane  # (chunks, w) candidate rows
        rows = slice(c0 * QC, c1 * QC)
        dx = qx[rows].reshape(-1, QC, 1) - cx[cols][:, None, :]
        dy = qy[rows].reshape(-1, QC, 1) - cy[cols][:, None, :]
        dz = qz[rows].reshape(-1, QC, 1) - cz[cols][:, None, :]
        d2 = (dx * dx + dy * dy) + dz * dz
        key = (d2.view(torch.int32) & -w) | lane.to(torch.int32)
        # the keys of a row are unique, so the k smallest are the k winners
        out[rows] = torch.topk(key.reshape(-1, w), k, dim=1, largest=False, sorted=True).values
    return out


def knn_windows_cuda(qx, qy, qz, xs, ys, zs, lo, *, w: int, k: int, frames: int = 1,
                     errors: torch.Tensor | None = None):
    """The same as ``knn_windows_plain``, by the kernel in ``csrc/knn.cu``.
    Needs contiguous CUDA tensors on one device; raises on any other input.
    The kernel checks the windows: one that leaves its frame sets a device
    flag (its rows hold -1). Without ``errors`` the wrapper reads its own
    flag before it returns (one host read) and raises; with ``errors``, an
    int32 (1,) CUDA tensor that the caller zeroes, the caller reads it."""
    check_cuda("knn_windows_cuda", {"qx": qx, "qy": qy, "qz": qz, "xs": xs, "ys": ys,
                                    "zs": zs, "lo": lo}, errors)
    _check(qx, qy, qz, xs, ys, zs, lo, w, k, frames, "knn_windows_cuda")
    bm = qx.shape[0]
    if max(bm * k, xs.numel()) >= 2**31:
        raise ValueError("knn_windows_cuda: tensors above 2^31 elements")
    lib = _lib()
    out = torch.empty((bm, k), dtype=torch.int32, device=qx.device)
    rows_pf = xs.shape[0] // frames
    kernel = ctypes.c_char_p()
    own = launch_with_flag("knn_windows_cuda", qx.device, errors, lambda e, s: lib.knn_launch(
        qx.data_ptr(), qy.data_ptr(), qz.data_ptr(), xs.data_ptr(), ys.data_ptr(), zs.data_ptr(),
        lo.data_ptr(), out.data_ptr(), bm, w, k, rows_pf, (bm // QC) // frames, e,
        ctypes.byref(kernel), s), lib.knn_error_string)
    if kernel.value:
        with _COUNT_LOCK:
            knn_windows_cuda.launches[kernel.value.decode()] += 1
    if own is not None and int(own.item()):
        raise ValueError(_outside_message("knn_windows_cuda", w, rows_pf))
    return out


# kernel launches since the last reset, per kernel of csrc/knn.cu (the one
# knn_launch reports it started: knn_select_kernel for k <= 32, else
# knn_rounds_kernel)
knn_windows_cuda.launches = {"knn_select_kernel": 0, "knn_rounds_kernel": 0}


def knn_windows(qx, qy, qz, xs, ys, zs, lo, *, w: int, k: int, frames: int = 1,
                errors: torch.Tensor | None = None):
    """Dispatch: the plain twin for CPU tensors, the kernel for CUDA tensors.
    ``errors`` goes to the kernel as in ``knn_windows_cuda``; the plain twin
    checks the windows itself and raises."""
    if qx.is_cuda:
        return knn_windows_cuda(qx, qy, qz, xs, ys, zs, lo, w=w, k=k, frames=frames,
                                errors=errors)
    return knn_windows_plain(qx, qy, qz, xs, ys, zs, lo, w=w, k=k, frames=frames)


def _gather3(xyz, idx):
    """(B, N, 3), (B, L) int64 → (B, L, 3)."""
    return torch.gather(xyz, 1, idx[..., None].expand(-1, -1, 3))


def sorted_windows(new_xyz, xyz, w: int, radius):
    """The window function's inputs for queries (B, M, 3) among candidates
    (B, N, 3), both x-sorted with stable sorts, and what ``nearest_k`` needs
    to map its winners back. Returns a dict: ``args`` (qx, qy, qz, xs, ys,
    zs, lo) for ``knn_windows`` with ``frames`` = B, and ``perm``, ``sxyz``,
    ``cperm``, ``scq``, ``start`` (B, M / 32) in rows, ``qlo``, ``qhi``."""
    b, n = xyz.shape[:2]
    m = new_xyz.shape[1]
    nchunk = m // QC
    perm = torch.argsort(xyz[..., 0], dim=-1, stable=True)
    sxyz = _gather3(xyz, perm)
    sx = sxyz[..., 0].contiguous()
    cperm = torch.argsort(new_xyz[..., 0], dim=-1, stable=True)
    scq = _gather3(new_xyz, cperm)

    # per-chunk needed span (sorted-rank units), frame-local
    qlo = scq[..., 0].reshape(b, nchunk, QC)[:, :, 0]
    qhi = scq[..., 0].reshape(b, nchunk, QC)[:, :, -1]
    r = torch.tensor(0.0 if radius is None else radius, dtype=torch.float32, device=xyz.device)
    lo_t = torch.searchsorted(sx, (qlo - r).contiguous(), side="left")
    hi_t = torch.searchsorted(sx, (qhi + r).contiguous(), side="right")
    # centre the window on the needed span, row-aligned, inside the frame;
    # lo_t + hi_t - w can be negative: floor division, then the clip
    start = torch.div(lo_t + hi_t - w, 2, rounding_mode="floor").clamp(0, n - w)
    start = torch.div(start, ROW, rounding_mode="floor")  # rows, int64

    row_off = torch.arange(b, device=xyz.device)[:, None] * (n // ROW)
    lo_flat = (start + row_off).reshape(b * nchunk).to(torch.int32)
    planar = [sxyz[..., c].reshape(b * (n // ROW), ROW).contiguous() for c in range(3)]
    q_flat = scq.reshape(b * m, 3)
    queries = [q_flat[:, c:c + 1].contiguous() for c in range(3)]
    return {"args": (*queries, *planar, lo_flat), "perm": perm, "sxyz": sxyz, "sx": sx,
            "cperm": cperm, "scq": scq, "start": start, "qlo": qlo, "qhi": qhi, "r": r}


def _prep_and_run(new_xyz, xyz, k: int, w: int, radius):
    """Sort, window, run the window function, map indices back, recompute
    exact d².

    Returns td2 (B, M, k) ascending exact float32, idx (B, M, k) int64 in
    the caller's candidate order, and cover_ok, a 0-dim bool tensor: the
    radius-window certificate, or with ``radius=None`` (three-NN mode) the
    post-hoc k-th distance certificate. The results are exact only where
    cover_ok holds. On the card no host read happens here: the kernel's
    window flag (never set, since every window is clipped into its frame)
    is folded into cover_ok, so a refused window fails the certificate."""
    b, n = xyz.shape[:2]
    m = new_xyz.shape[1]
    nchunk = m // QC
    s = sorted_windows(new_xyz, xyz, w, radius)
    start, sx, sxyz, scq = s["start"], s["sx"], s["sxyz"], s["scq"]
    e_lo, e_hi = torch.gather(sx, 1, start * ROW), torch.gather(sx, 1, start * ROW + (w - 1))
    at_first, at_last = start == 0, start * ROW + w >= n
    if radius is not None:  # coverage: window ⊇ [qlo − r, qhi + r] per chunk
        cover_ok = ((at_first | (e_lo <= s["qlo"] - s["r"]))
                    & (at_last | (e_hi >= s["qhi"] + s["r"]))).all()

    errors = torch.zeros(1, dtype=torch.int32, device=xyz.device) if xyz.is_cuda else None
    packed = knn_windows(*s["args"], w=w, k=k, frames=b, errors=errors).reshape(b, m, k)

    # window-local → frame-sorted → caller's candidate index
    local = (packed & (w - 1)).long()
    srt = local + (start.repeat_interleave(QC, dim=1) * ROW)[..., None]  # (B, M, k)
    idx = torch.gather(s["perm"], 1, srt.reshape(b, m * k)).reshape(b, m, k)

    # exact winner distances (the key's low bits held the index), re-sorted
    # by the exact values: the key's quantisation can swap near-ties, and
    # callers slice prefixes of the ascending order
    d = _gather3(sxyz, srt.reshape(b, m * k)).reshape(b, m, k, 3) - scq[:, :, None, :]
    td2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    order = torch.argsort(td2, dim=-1, stable=True)
    td2 = torch.gather(td2, -1, order)
    idx = torch.gather(idx, -1, order)

    if radius is None:  # no candidate outside the window beats the k-th winner
        dk = td2[..., -1].reshape(b, nchunk, QC)
        qx = scq[..., 0].reshape(b, nchunk, QC)
        gap_lo, gap_hi = qx - e_lo[..., None], e_hi[..., None] - qx
        cover_ok = ((at_first[..., None] | (gap_lo * gap_lo >= dk))
                    & (at_last[..., None] | (gap_hi * gap_hi >= dk))).all()

    if errors is not None:
        cover_ok = cover_ok & (errors[0] == 0)

    # back to the caller's query order
    inv = torch.empty_like(s["cperm"])
    inv.scatter_(1, s["cperm"], torch.arange(m, device=inv.device).expand(b, m))
    inv = inv[..., None].expand(-1, -1, k)
    return torch.gather(td2, 1, inv), torch.gather(idx, 1, inv), cover_ok


def nearest_k(new_xyz, xyz, k: int, radius=None, *, dense_fn=None):
    """(B, M, 3), (B, N, 3) float32 → (td2 (B, M, k) ascending exact
    float32, idx (B, M, k) int64).

    The windowed kernel with its certificate. Without ``dense_fn`` it
    returns (td2, idx, cover_ok). With it, one host read of the certificate
    decides: where it fails, ``dense_fn(new_xyz, xyz, k)`` answers for the
    whole batch (the kernel has run all the same, as under JAX's
    ``lax.cond``), and ``nearest_k.dense_fallbacks`` counts it.

    Shapes must satisfy ``knn_supported``: with n < 2w the window clip has
    min > max and would start windows outside the frame."""
    m, n = new_xyz.shape[1], xyz.shape[1]
    if not knn_supported(m, n, k):
        raise ValueError(
            f"nearest_k: unsupported shapes m={m} n={n} k={k} (need m%{QC}==0, n%{ROW}==0, "
            f"n>=2*window, k<=window//4); use the dense path instead")
    if new_xyz.device != xyz.device or new_xyz.dtype != torch.float32 \
            or xyz.dtype != torch.float32:
        raise ValueError("nearest_k needs float32 points on one device")
    td2, idx, ok = _prep_and_run(new_xyz, xyz, k, _pick_window(n), radius)
    if dense_fn is None:
        return td2, idx, ok
    if bool(ok):
        return td2, idx
    with _COUNT_LOCK:
        nearest_k.dense_fallbacks += 1
    return dense_fn(new_xyz, xyz, k)


nearest_k.dense_fallbacks = 0  # calls answered by dense_fn since the last reset
