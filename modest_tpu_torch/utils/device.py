"""Device selection and stage timing shared by the port's entry points."""
from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``. A CUDA device must exist unless the
    caller asks for the CPU: nothing falls back quietly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def device_ms(fn, dev: torch.device, iters: int):
    """Mean time per call of ``fn`` on the card by CUDA events, over
    ``iters`` calls after one warm-up; None off the card (times come from
    the card only)."""
    if dev.type != "cuda":
        return None
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / iters


class StageTimer:
    """Host wall time per named stage, summed over calls. On a CUDA device
    each stage starts and ends with ``torch.cuda.synchronize()``, so a
    stage's time includes its device work; pass no timer (``None``) to the
    entry points to run without these syncs."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds: dict[str, float] = collections.defaultdict(float)
        self.calls: dict[str, int] = collections.defaultdict(int)
        self._lock = threading.Lock()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def stage(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            with self._lock:
                self.seconds[name] += time.perf_counter() - t0
                self.calls[name] += 1

    def ms(self) -> dict[str, float]:
        return {k: v * 1e3 for k, v in self.seconds.items()}


def stage(timer: StageTimer | None, name: str):
    """``timer.stage(name)``, or a no-op context without a timer."""
    return timer.stage(name) if timer is not None else contextlib.nullcontext()
