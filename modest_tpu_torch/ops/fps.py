"""Furthest point sampling: the hand-written CUDA kernel and its plain twin.

Port of ``modest_tpu/ops/pallas_fps.py``. ``furthest_point_sample_cuda``
launches ``csrc/fps.cu`` on CUDA tensors; ``furthest_point_sample_plain`` is
the same computation as a PyTorch loop over the ``npoint`` steps (the
arithmetic of ``modest_tpu/ops/pointnet2.py::_furthest_point_sample_xla``).
The dispatcher is ``modest_tpu_torch.ops.pointnet2.furthest_point_sample``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load_library


@functools.cache
def _lib():
    lib = load_library("fps")
    lib.fps_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p]
    lib.fps_launch.restype = ctypes.c_int
    lib.fps_max_points.argtypes = []
    lib.fps_max_points.restype = ctypes.c_int
    lib.fps_error_string.argtypes = [ctypes.c_int]
    lib.fps_error_string.restype = ctypes.c_char_p
    return lib


def furthest_point_sample_plain(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) → (B, npoint) int32. Starts at index 0 with distances 1e10;
    each step takes the argmax of the running min squared distance to the
    selected set (``torch.argmax`` returns the first maximal index)."""
    b, n, _ = xyz.shape
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    rows = torch.arange(b, device=xyz.device)
    dists = torch.full((b, n), 1e10, dtype=torch.float32, device=xyz.device)
    idx = torch.zeros((b, npoint), dtype=torch.int32, device=xyz.device)
    last = torch.zeros(b, dtype=torch.long, device=xyz.device)
    for i in range(1, npoint):
        dx = x - x[rows, last][:, None]
        dy = y - y[rows, last][:, None]
        dz = z - z[rows, last][:, None]
        dists = torch.minimum(dists, dx * dx + dy * dy + dz * dz)
        last = torch.argmax(dists, dim=1)
        idx[:, i] = last.to(torch.int32)
    return idx


def furthest_point_sample_cuda(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) float32 contiguous CUDA tensor → (B, npoint) int32, by the
    kernel in ``csrc/fps.cu``. Raises on any other input."""
    if not xyz.is_cuda:
        raise ValueError(f"furthest_point_sample_cuda needs a CUDA tensor, got {xyz.device}")
    if xyz.dtype != torch.float32:
        raise ValueError(f"furthest_point_sample_cuda needs float32, got {xyz.dtype}")
    if xyz.ndim != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"furthest_point_sample_cuda needs (B, N, 3), got {tuple(xyz.shape)}")
    if not xyz.is_contiguous():
        raise ValueError("furthest_point_sample_cuda needs a contiguous tensor")
    b, n, _ = xyz.shape
    lib = _lib()
    if not (b >= 1 and 1 <= n <= lib.fps_max_points() and npoint >= 1):
        raise ValueError(f"furthest_point_sample_cuda: unsupported B={b}, N={n}, "
                         f"npoint={npoint} (N <= {lib.fps_max_points()})")
    out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    kernel = ctypes.c_char_p()
    with torch.cuda.device(xyz.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fps_launch(xyz.data_ptr(), out.data_ptr(), b, n, npoint, ctypes.byref(kernel),
                             stream)
    if err != 0:
        raise RuntimeError(f"fps kernel launch failed: {lib.fps_error_string(err).decode()}")
    furthest_point_sample_cuda.launches[kernel.value.decode()] += 1
    return out


# kernel launches since the last reset, per kernel of csrc/fps.cu (the one
# fps_launch reports it started)
furthest_point_sample_cuda.launches = {"fps_block_kernel": 0, "fps_warp_kernel": 0}
