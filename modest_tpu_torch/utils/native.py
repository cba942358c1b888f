"""ctypes bindings for the host library ``csrc/modest_host.cpp`` — port of
``modest_tpu/utils/native.py``.

The library is built by ``g++`` at first use into
``build/modest_tpu_torch/libmodest_host-<hash>.so`` (the hash is of the
source and flags, as for the CUDA kernels in ``ops/_build.py``). Where no
compiler is found the numpy paths run instead, as in the JAX package;
``bev_iou`` and ``bev_overlap`` then use ``ops/iou3d.py`` on CPU tensors.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "modest_host.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "modest_tpu_torch"
# the JAX package's flags: no -march=native, so no FMA contraction either
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha1(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:12]
    return _BUILD_DIR / f"libmodest_host-{digest}.so"


def _build(so: Path) -> bool:
    gxx = shutil.which("g++")
    if gxx is None:
        return False
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([gxx, *_FLAGS, str(_SRC), "-o", str(tmp)], capture_output=True,
                          check=False)
    if proc.returncode != 0:
        return False
    os.replace(tmp, so)  # atomic: another process never loads a half-written library
    return True


def get_lib():
    """The loaded library, or None where it cannot be built."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = library_path()
        if not so.exists() and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        c = ctypes
        lib.mh_load_velo.restype = c.c_int64
        lib.mh_load_velo.argtypes = [c.c_char_p, c.c_void_p, c.c_int64]
        lib.mh_fov_mask.restype = None
        lib.mh_fov_mask.argtypes = [c.c_void_p, c.c_int64, c.c_void_p, c.c_void_p,
                                    c.c_double, c.c_double, c.c_void_p]
        lib.mh_points_in_boxes.restype = None
        lib.mh_points_in_boxes.argtypes = [c.c_void_p, c.c_int64, c.c_int64,
                                           c.c_void_p, c.c_int64, c.c_void_p]
        lib.mh_bev_overlap.restype = None
        lib.mh_bev_overlap.argtypes = [c.c_void_p, c.c_int64, c.c_void_p, c.c_int64, c.c_void_p]
        lib.mh_bev_iou.restype = None
        lib.mh_bev_iou.argtypes = [c.c_void_p, c.c_int64, c.c_void_p, c.c_int64, c.c_void_p]
        lib.mh_match_stats.restype = None
        lib.mh_match_stats.argtypes = [c.c_void_p, c.c_int64, c.c_int64, c.c_void_p, c.c_void_p,
                                       c.c_void_p, c.c_double, c.c_void_p, c.c_int64,
                                       c.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def load_velo(path, max_points: int = 400_000):
    lib = get_lib()
    if lib is None:
        return np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    buf = np.empty((max_points, 4), np.float32)
    n = lib.mh_load_velo(str(path).encode(), _ptr(buf), max_points * 4)
    if n < 0:
        return np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    return buf[:n].copy()


def fov_mask(points: np.ndarray, rect_3x4: np.ndarray, P_3x4: np.ndarray,
             img_shape) -> np.ndarray:
    """points (N,4) f32 velodyne → bool FOV mask (native or numpy)."""
    lib = get_lib()
    pts = np.ascontiguousarray(points[:, :4], np.float32)
    if lib is None:
        rect = pts[:, :3] @ rect_3x4[:, :3].T + rect_3x4[:, 3]
        uvw = rect @ P_3x4[:, :3].T + P_3x4[:, 3]
        uv = uvw[:, :2] / uvw[:, 2:3]
        depth = uvw[:, 2] - P_3x4[2, 3]
        return ((uv[:, 0] >= 0) & (uv[:, 0] < img_shape[1])
                & (uv[:, 1] >= 0) & (uv[:, 1] < img_shape[0]) & (depth >= 0))
    mask = np.empty(len(pts), np.uint8)
    lib.mh_fov_mask(_ptr(pts), len(pts),
                    _ptr(np.ascontiguousarray(rect_3x4, np.float64)),
                    _ptr(np.ascontiguousarray(P_3x4, np.float64)),
                    float(img_shape[0]), float(img_shape[1]), _ptr(mask))
    return mask.astype(bool)


def points_in_boxes_index(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """(N,) index of the first containing rotated box, -1 if none."""
    lib = get_lib()
    if lib is None or len(boxes) == 0:
        from . import box_np

        return box_np.points_in_box_index(points[:, :3], boxes)
    pts = np.ascontiguousarray(points, np.float32)
    bxs = np.ascontiguousarray(boxes[:, :7], np.float32)
    out = np.empty(len(pts), np.int32)
    lib.mh_points_in_boxes(_ptr(pts), len(pts), pts.shape[1], _ptr(bxs), len(bxs), _ptr(out))
    return out.astype(np.int64)


def _bev_pairs(fn_name: str, torch_fn: str, boxes_a: np.ndarray, boxes_b: np.ndarray):
    if len(boxes_a) == 0 or len(boxes_b) == 0:
        return np.zeros((len(boxes_a), len(boxes_b)))
    a = np.ascontiguousarray(boxes_a[:, :7], np.float32)
    b = np.ascontiguousarray(boxes_b[:, :7], np.float32)
    lib = get_lib()
    if lib is None:
        import torch

        from ..ops import iou3d

        return getattr(iou3d, torch_fn)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    out = np.empty((len(a), len(b)), np.float64)
    getattr(lib, fn_name)(_ptr(a), len(a), _ptr(b), len(b), _ptr(out))
    return out


def bev_iou(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """(N, M) rotated BEV IoU on the host."""
    return _bev_pairs("mh_bev_iou", "boxes_iou_bev", boxes_a, boxes_b)


def bev_overlap(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """(N, M) rotated BEV intersection areas on the host."""
    return _bev_pairs("mh_bev_overlap", "boxes_overlap_bev", boxes_a, boxes_b)


def match_stats(overlaps, scores, ignored_gt, ignored_det, min_overlap, thresholds):
    """Per-threshold (tp, fp, fn), (T, 3) int64, of the KITTI eval's greedy
    matcher on one frame (no DontCare boxes), or None without the library:
    the caller then runs ``eval/kitti_eval.py::compute_statistics``."""
    lib = get_lib()
    if lib is None:
        return None
    ov = np.ascontiguousarray(overlaps, np.float64)
    sc = np.ascontiguousarray(scores, np.float64)
    ig = np.ascontiguousarray(ignored_gt, np.int64)
    idt = np.ascontiguousarray(ignored_det, np.int64)
    th = np.ascontiguousarray(thresholds, np.float64)
    if ov.size != len(sc) * len(ig) or len(idt) != len(sc):
        raise ValueError(f"match_stats: overlaps {ov.shape} for {len(sc)} detections "
                         f"({len(idt)} flags) and {len(ig)} gt boxes")
    out = np.zeros((len(th), 3), np.int64)
    lib.mh_match_stats(_ptr(ov), len(sc), len(ig), _ptr(sc), _ptr(ig), _ptr(idt),
                       float(min_overlap), _ptr(th), len(th), _ptr(out))
    return out
