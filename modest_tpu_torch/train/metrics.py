"""Training metrics sink — port of ``modest_tpu/train/metrics.py``.

Always writes ``metrics.jsonl`` (one JSON object per call) and mirrors the
scalars to TensorBoard whenever ``torch.utils.tensorboard`` can be imported
(the card's machine has no tensorboard package).
"""
from __future__ import annotations

import json
import time
from pathlib import Path


class MetricsLogger:
    def __init__(self, log_dir):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._f = open(self.log_dir / "metrics.jsonl", "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # no tensorboard package: JSONL only
            pass
        else:
            self._tb = SummaryWriter(str(self.log_dir / "tensorboard"))

    def log(self, step: int, scalars: dict, prefix: str = ""):
        rec = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            key = f"{prefix}{k}"
            try:
                rec[key] = float(v)
            except (TypeError, ValueError):
                continue
            if self._tb is not None:
                self._tb.add_scalar(key, rec[key], step)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
