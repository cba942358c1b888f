"""Label-table gathers: the CUDA kernels and their plain twins.

Port of the Pallas probe kernels of ``scripts_dev/gather_probe.py``, which
asked how a DBSCAN propagation round could gather labels on the TPU:

* ``take`` (``pallas_take``): ``table[idx]``, table (N,) int32, idx any
  shape int32 → the shape of idx;
* ``take_along_axis`` (``pallas_taa``): row-wise, ``out[r, j] =
  tab[r, idx[r, j]]``, tab (R, W) int32, idx (R, M) int32 → (R, M).

An index outside its table raises ``IndexError``; nothing is clamped. The
``*_cuda`` wrappers launch ``csrc/gather.cu`` on CUDA tensors; the kernel
marks a bad index in a device flag, which the wrapper reads before it
returns (one host read), unless the caller passes its own ``errors`` flag to
read later with ``raise_on_errors`` (one host read for many launches). The
``*_plain`` twins are the same functions in PyTorch; ``take`` and
``take_along_axis`` take the plain twin for CPU tensors and the kernel for
CUDA tensors.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from ._build import check_cuda, launch_with_flag, load_library

_COUNT_LOCK = threading.Lock()


@functools.cache
def _lib():
    lib = load_library("gather")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.take_launch.argtypes = [vp, i, vp, vp, ctypes.c_longlong, vp, vp]
    lib.take_launch.restype = i
    lib.take_along_axis_launch.argtypes = [vp, i, vp, vp, i, i, vp, vp]
    lib.take_along_axis_launch.restype = i
    lib.gather_error_string.argtypes = [i]
    lib.gather_error_string.restype = ctypes.c_char_p
    return lib


def _check_take(table, idx, where: str):
    if table.dtype != torch.int32 or idx.dtype != torch.int32:
        raise ValueError(f"{where} needs an int32 table and int32 indices, "
                         f"got {table.dtype} and {idx.dtype}")
    if table.ndim != 1:
        raise ValueError(f"{where} needs a table (N,), got {tuple(table.shape)}")


def _check_take_along_axis(tab, idx, where: str):
    if tab.dtype != torch.int32 or idx.dtype != torch.int32:
        raise ValueError(f"{where} needs an int32 table and int32 indices, "
                         f"got {tab.dtype} and {idx.dtype}")
    if tab.ndim != 2 or idx.ndim != 2 or idx.shape[0] != tab.shape[0]:
        raise ValueError(f"{where} needs tab (R, W) and idx (R, M), "
                         f"got {tuple(tab.shape)} and {tuple(idx.shape)}")


def _check_range(idx, n: int, where: str):
    # one host read
    if idx.numel() and bool(((idx < 0) | (idx >= n)).any()):
        raise IndexError(f"{where}: an index lies outside its table of {n}")


def raise_on_errors(errors: torch.Tensor, where: str = "gather") -> None:
    """One host read of a kernel error flag: raise if a kernel that wrote
    to it met an index outside its table."""
    if int(errors.item()):
        raise IndexError(f"{where}: an index lies outside its table")


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------


def take_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    _check_take(table, idx, "take_plain")
    _check_range(idx, table.shape[0], "take_plain")
    return table[idx.long()]


def take_along_axis_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    _check_take_along_axis(tab, idx, "take_along_axis_plain")
    _check_range(idx, tab.shape[1], "take_along_axis_plain")
    return torch.gather(tab, 1, idx.long())


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


def take_cuda(table: torch.Tensor, idx: torch.Tensor,
              errors: torch.Tensor | None = None) -> torch.Tensor:
    """``take_plain`` by the kernel in ``csrc/gather.cu``. ``errors``, an
    int32 (1,) CUDA tensor that the caller zeroes and reads, collects bad
    indices across launches; without it the wrapper reads its own flag."""
    check_cuda("take_cuda", {"table": table, "idx": idx}, errors)
    _check_take(table, idx, "take_cuda")
    if table.shape[0] >= 2**31:
        raise ValueError("take_cuda: a table above 2^31 entries")
    out = torch.empty_like(idx)
    lib = _lib()
    own = launch_with_flag("take_cuda", idx.device, errors, lambda e, s: lib.take_launch(
        table.data_ptr(), table.shape[0], idx.data_ptr(), out.data_ptr(), idx.numel(), e, s),
        lib.gather_error_string)
    with _COUNT_LOCK:
        take_cuda.launches += 1
    if own is not None:
        raise_on_errors(own, "take_cuda")
    return out


take_cuda.launches = 0  # kernel launches since the last reset


def take_along_axis_cuda(tab: torch.Tensor, idx: torch.Tensor,
                         errors: torch.Tensor | None = None) -> torch.Tensor:
    """``take_along_axis_plain`` by the kernel in ``csrc/gather.cu``;
    ``errors`` as in ``take_cuda``."""
    check_cuda("take_along_axis_cuda", {"tab": tab, "idx": idx}, errors)
    _check_take_along_axis(tab, idx, "take_along_axis_cuda")
    if max(tab.numel(), idx.numel()) >= 2**31:
        raise ValueError("take_along_axis_cuda: tensors above 2^31 elements")
    out = torch.empty_like(idx)
    lib = _lib()
    own = launch_with_flag("take_along_axis_cuda", idx.device, errors,
                           lambda e, s: lib.take_along_axis_launch(
                               tab.data_ptr(), tab.shape[1], idx.data_ptr(), out.data_ptr(),
                               idx.shape[0], idx.shape[1], e, s),
                           lib.gather_error_string)
    with _COUNT_LOCK:
        take_along_axis_cuda.launches += 1
    if own is not None:
        raise_on_errors(own, "take_along_axis_cuda")
    return out


take_along_axis_cuda.launches = 0  # kernel launches since the last reset


def take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Dispatch: the plain twin for CPU tensors, the kernel for CUDA tensors."""
    return take_cuda(table, idx) if idx.is_cuda else take_plain(table, idx)


def take_along_axis(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Dispatch: the plain twin for CPU tensors, the kernel for CUDA tensors."""
    return take_along_axis_cuda(tab, idx) if idx.is_cuda else take_along_axis_plain(tab, idx)
