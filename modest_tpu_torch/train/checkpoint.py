"""Checkpoints as ``torch.save`` files — port of ``modest_tpu/train/checkpoint.py``
(orbax there; the reference's .pth dicts, train_utils.py:118-152).

``ckpt_dir/checkpoint_epoch_{E}.pth`` holds pcdet's keys: ``epoch``,
``model_state`` (the state dict, whose keys are pcdet's) and
``optimizer_state``, and ``format``: ``FORMAT``, which tells this package's
files from pcdet's (whose SECOND layouts differ, ``models/convert.py``). The
newest ``max_to_keep`` files are kept. In a process group rank 0 writes
them and every process reads them.
"""
from __future__ import annotations

import os
import re
from pathlib import Path

import torch

from ..parallel.mesh import barrier, world

_NAME = re.compile(r"checkpoint_epoch_(\d+)\.pth")
FORMAT = "modest_tpu_torch"


class CheckpointManager:
    def __init__(self, ckpt_dir, max_to_keep: int = 30):
        self.dir = Path(ckpt_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def path(self, epoch: int) -> Path:
        return self.dir / f"checkpoint_epoch_{epoch}.pth"

    def epochs(self) -> list[int]:
        return sorted(int(m.group(1)) for p in self.dir.iterdir()
                      if (m := _NAME.fullmatch(p.name)))

    def latest_epoch(self) -> int | None:
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def save(self, state, epoch: int, extra: dict | None = None) -> Path:
        """Write epoch ``epoch``'s checkpoint and drop the oldest past
        ``max_to_keep``. In a process group only rank 0 writes (the
        processes hold the same state), then every process waits for it."""
        path = self.path(epoch)
        if world()[0] == 0:
            payload = {"epoch": epoch, "model_state": state.model.state_dict(),
                       "optimizer_state": state.optimizer.state_dict(), "extra": extra or {},
                       "format": FORMAT}
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            torch.save(payload, tmp)
            os.replace(tmp, path)  # a reader never sees half a file
            for old in self.epochs()[:-self.max_to_keep]:
                self.path(old).unlink()
        barrier()
        return path

    def _load(self, epoch: int | None):
        epoch = self.latest_epoch() if epoch is None else epoch
        return None if epoch is None else torch.load(self.path(epoch), map_location="cpu")

    def restore(self, state, epoch: int | None = None) -> int | None:
        """Load ``epoch`` (the latest when None) into ``state``; returns the
        epoch, or None when the directory holds no checkpoint."""
        payload = self._load(epoch)
        if payload is None:
            return None
        state.model.load_state_dict(payload["model_state"])
        state.optimizer.load_state_dict(payload["optimizer_state"])
        return int(payload["epoch"])

    def restore_model(self, model, epoch: int | None = None) -> int | None:
        """``restore`` of the weights alone, for evaluation."""
        payload = self._load(epoch)
        if payload is None:
            return None
        model.load_state_dict(payload["model_state"])
        return int(payload["epoch"])


def load_params_partial(model, source, epoch: int | None = None, logger=None):
    """Transfer load: copy the tensors of a checkpoint whose key and shape
    match ``model``'s, keep the rest as they are (reference
    detector3d_template.load_params_from_file:327-353). ``source`` is a
    ``.pth`` file (this package's or pcdet's: its ``model_state``, or the
    file itself when it is a bare state dict) or a checkpoint directory
    (``epoch``, or the latest). A file without this package's ``format``
    mark (a pcdet checkpoint, or a bare state dict) is read in pcdet's
    layouts (``models.convert.state_dict_from_pcdet``). Returns (n_loaded,
    n_skipped)."""
    source = Path(source)
    if source.is_dir():
        manager = CheckpointManager(source)
        epoch = manager.latest_epoch() if epoch is None else epoch
        if epoch is None:
            raise FileNotFoundError(f"no checkpoint in {source}")
        source = manager.path(epoch)
    payload = torch.load(source, map_location="cpu")
    old = payload.get("model_state", payload)
    if payload.get("format") != FORMAT:
        from ..models.convert import state_dict_from_pcdet

        old = state_dict_from_pcdet(old, model)
    own = model.state_dict()
    take = {k: v for k, v in old.items() if k in own and tuple(v.shape) == tuple(own[k].shape)}
    model.load_state_dict(take, strict=False)
    skipped = [k for k in own if k not in take]
    if logger is not None:
        for k in skipped:
            logger.info(f"partial load: keeping {k} as initialised")
    return len(take), len(skipped)
