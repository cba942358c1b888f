"""Build the hand-written CUDA kernels under ``csrc/`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into ``build/modest_tpu_torch/lib<name>-<hash>.so`` at the repository root
(the hash is of the source, so an edited source rebuilds), then loaded with
``ctypes``. Nothing here runs at import time. ``check_cuda`` and
``launch_with_flag`` are the input checks and the error-flag handling that
the kernel wrappers share.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "modest_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` if its library is missing; returns its path.
    The compiler's resource report (``-Xptxas -v``) goes to ``<lib>.log``."""
    lib = library_path(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: another process never loads a half-written library
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    return lib


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name)))


def check_cuda(where: str, tensors: dict, errors: torch.Tensor | None = None) -> None:
    """Raise ``ValueError`` unless every tensor of ``tensors`` (name →
    tensor), and ``errors`` where given, is a contiguous CUDA tensor on one
    device, and ``errors`` is an int32 flag of one element."""
    if errors is not None:
        if errors.dtype != torch.int32 or errors.numel() != 1:
            raise ValueError(f"{where} needs an int32 errors flag of one element")
        tensors = {**tensors, "errors": errors}
    for name, x in tensors.items():
        if not x.is_cuda:
            raise ValueError(f"{where} needs CUDA tensors, {name} is on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{where} needs contiguous {name}")
    if len({x.device for x in tensors.values()}) != 1:
        raise ValueError(f"{where} needs all tensors on one device")


def launch_with_flag(where: str, device, errors, launch, error_string):
    """Run ``launch(errors_ptr, stream)`` on ``device``'s current stream for a
    kernel that sets a device error flag. ``errors`` is the caller's flag,
    or None for a fresh zeroed one. Raises ``RuntimeError`` with
    ``error_string(code)`` when the launch returns a non-zero code. Returns
    the flag the wrapper must read itself: its own, or None when the caller
    passed one (and reads it)."""
    own = errors is None
    with torch.cuda.device(device):
        if own:
            errors = torch.zeros(1, dtype=torch.int32, device=device)
        err = launch(errors.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{where} kernel launch failed: {error_string(err).decode()}")
    return errors if own else None
