"""What a per-layer metric's reader is given: one traced run's readings."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class TraceContext:
    cell: object            # manifest.Cell
    batch: int              # scans a batch (eval) or step (train)
    batch_s: float          # mean host time of a batch outside the profiled span
    stage_ms: dict = field(default_factory=dict)   # stage → mean ms a batch (CUDA events)
    profile: dict | None = None                    # harness/trace.py::reduce_profile
    flops_per_batch: float | None = None           # harness/flops.py, on the reference
    data_wait_ms: float | None = None              # host wait for the next batch (train)

    def stage(self, *names) -> float | None:
        """Mean ms a batch of the named stages together, or None if any is
        missing."""
        if not all(n in self.stage_ms for n in names):
            return None
        return sum(self.stage_ms[n] for n in names)
