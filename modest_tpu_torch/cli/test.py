"""CLI: evaluate a detector checkpoint — port of ``modest_tpu/cli/test.py``
(reference tools/test.py).

Usage:
  python -m modest_tpu_torch.cli.test --cfg_file configs/models/lyft_models/pointrcnn_dynamic_obj.yaml \\
      --ckpt_dir <dir> [--ckpt_epoch N] [--batch_size B] [--device cpu] [--set KEY VALUE ...]

Writes ``<output>/eval/epoch_<E>/<split>/result.pkl`` (the KITTI annos that
``combine_labels`` reads for self-training) and prints the recall and the
range-bucketed R40 AP. ``--ckpt_dir`` holds the train CLI's checkpoints;
``--torch_ckpt`` loads a pcdet ``.pth`` (or this package's) by key, as the
train CLI's ``--pretrained_model`` does; ``--eval_all`` evaluates every
checkpoint of ``--ckpt_dir`` and then waits up to ``--max_waiting_mins`` for
new ones, keeping the epochs done in ``eval_list_<split>.txt``. Runs on the
card unless ``--device cpu``; without CUDA the default raises.
``--num_devices N`` evaluates in N processes on this host, one card each (or
N on the CPU with ``--device cpu``), each on its shard of the split at a
global batch of ``--batch_size`` or ``BATCH_SIZE_PER_GPU`` × N; rank 0
merges the shards and evaluates, and ``main`` returns None once they all
have ended. ``--set`` comes last.
"""
from __future__ import annotations

import argparse
import datetime
import sys
import time
from pathlib import Path

import numpy as np

from ..data.loader import build_dataloader
from ..models import build_network
from ..parallel.mesh import broadcast_object, world
from ..parallel.multihost import init_multihost, shutdown, spawn_local
from ..train.checkpoint import CheckpointManager, load_params_partial
from ..train.loop import eval_one_epoch
from ..utils.config import cfg_from_list
from ..utils.device import resolve_device
from .train import create_logger, load_model_config

POLL_SECONDS = 30


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="evaluate a detector")
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--ckpt_dir", type=str, default=None)
    parser.add_argument("--torch_ckpt", type=str, default=None,
                        help="evaluate a .pth checkpoint (pcdet's keys), loaded by key")
    parser.add_argument("--ckpt_epoch", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--extra_tag", type=str, default="default")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="evaluate in this many processes on this host, one device each")
    parser.add_argument("--data_path", type=str, default=None)
    parser.add_argument("--output_dir", type=str, default=None)
    parser.add_argument("--save_to_file", action="store_true")
    parser.add_argument("--workers", type=int, default=4, help="batch-building worker processes")
    parser.add_argument("--eval_all", action="store_true",
                        help="evaluate every checkpoint in ckpt_dir, polling for new ones")
    parser.add_argument("--max_waiting_mins", type=int, default=30,
                        help="with --eval_all: minutes to wait for a new checkpoint")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def main(argv=None):
    """Evaluate; returns (det_annos, results) of the last epoch evaluated
    (None with ``--num_devices`` > 1: the results are in the output
    directory)."""
    args = parse_args(argv)
    if not (args.ckpt_dir or args.torch_ckpt):
        raise ValueError("--ckpt_dir or --torch_ckpt is required")
    if (args.num_devices or 1) > 1:
        spawn_local(_spawned_rank, args.num_devices, args.device,
                    (sys.argv[1:] if argv is None else list(argv),))
        return None
    return _test(args, resolve_device(args.device))


def _spawned_rank(rank: int, nprocs: int, coordinator: str, argv):
    """Process ``rank`` of the ``--num_devices`` processes that ``main``
    starts."""
    args = parse_args(argv)
    device = init_multihost(coordinator, nprocs, rank, args.device)
    try:
        _test(args, device)
    finally:
        shutdown()


def _test(args, device):
    rank, size = world()
    cfg = load_model_config(args.cfg_file)
    cfg.TAG = Path(args.cfg_file).stem
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs, cfg)
    if args.data_path is not None:
        cfg.DATA_CONFIG.DATA_PATH = args.data_path
    np.random.seed(1024)

    out_root = (Path(args.output_dir) if args.output_dir
                else Path("output") / cfg.TAG / args.extra_tag)
    batch_size = args.batch_size or int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU) * size
    eval_set, eval_loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size,
                                             training=False, num_workers=args.workers)
    model = build_network(cfg.MODEL, num_class=len(cfg.CLASS_NAMES), device=device,
                          dataset=eval_set)
    split = cfg.DATA_CONFIG.DATA_SPLIT["test"]

    def eval_epoch(epoch):
        result_dir = out_root / "eval" / f"epoch_{epoch}" / split
        result_dir.mkdir(parents=True, exist_ok=True)
        log_file = result_dir / f"log_eval_{datetime.datetime.now():%Y%m%d-%H%M%S}.txt"
        logger = create_logger(log_file if rank == 0 else None, rank)
        logger.info(f"evaluating epoch {epoch} on split {split}; device: {device}")
        return eval_one_epoch(model, cfg.MODEL, eval_loader, eval_set, cfg.CLASS_NAMES,
                              device=device, result_dir=result_dir, logger=logger,
                              save_to_file=args.save_to_file)

    try:
        if args.torch_ckpt is not None:
            n_loaded, n_skipped = load_params_partial(model, args.torch_ckpt)
            print(f"loaded {n_loaded} tensors from {args.torch_ckpt}, {n_skipped} kept at init")
            return eval_epoch("torch_ckpt")

        manager = CheckpointManager(args.ckpt_dir)
        if not args.eval_all:
            epoch = manager.restore_model(model, args.ckpt_epoch)
            if epoch is None:
                raise FileNotFoundError(f"no checkpoint found in {args.ckpt_dir}")
            return eval_epoch(epoch)

        # --eval_all: every checkpoint, then poll for new ones until none has
        # come for max_waiting_mins (reference test.py repeat_eval_ckpt:101-113)
        record = out_root / "eval" / f"eval_list_{split}.txt"
        record.parent.mkdir(parents=True, exist_ok=True)
        done = {int(x) for x in record.read_text().split()} if record.exists() else set()
        last_new = time.time()
        results = None
        while True:
            # rank 0's view of the directory decides for every process
            pending = sorted(set(manager.epochs()) - done)
            waited = (time.time() - last_new) / 60
            pending, waited = broadcast_object((pending, waited))
            if not pending:
                if waited > args.max_waiting_mins:
                    print(f"no new checkpoint for {waited:.1f} min: exiting")
                    return results
                time.sleep(POLL_SECONDS)
                continue
            epoch = manager.restore_model(model, pending[0])
            results = eval_epoch(epoch)
            done.add(epoch)
            if rank == 0:
                record.write_text("".join(f"{e}\n" for e in sorted(done)))
            last_new = time.time()
    finally:
        eval_loader.close()


if __name__ == "__main__":
    main()
