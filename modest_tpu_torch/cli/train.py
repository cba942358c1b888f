"""CLI: train a detector — port of ``modest_tpu/cli/train.py`` (reference
tools/train.py).

Usage:
  python -m modest_tpu_torch.cli.train --cfg_file configs/models/lyft_models/pointrcnn_dynamic_obj.yaml \\
      [--batch_size B] [--epochs E] [--extra_tag TAG] [--fix_random_seed] [--device cpu] \\
      [--merge_all_iters_to_one_epoch] [--output_dir DIR] [--set KEY VALUE ...]

Runs on the card unless ``--device cpu``; without CUDA the default raises.
PointRCNN, PointPillars and SECOND train (``pointrcnn_dynamic_obj.yaml``,
``pointpillar_dynamic_obj.yaml``, ``second_dynamic_obj.yaml`` of
``configs/models/lyft_models/``). When ``--cfg_file`` names a config that ships as a dict
(``configs.SHIPPED_MODEL_CONFIGS``) no YAML parser is needed; any other file
is read with PyYAML. One process on one device: multi-process training
(``--launcher``, ``--num_devices`` > 1) is not ported and raises. A run
resumes from the newest checkpoint in its output directory;
``--eval_after_train`` then evaluates the trained weights on the test split
(``eval/epoch_<E>/val/result.pkl``), as ``cli/test.py`` does.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import datetime
import logging
from pathlib import Path

import numpy as np

from ..configs import SHIPPED_MODEL_CONFIGS
from ..data.loader import build_dataloader
from ..models import build_network
from ..train.checkpoint import CheckpointManager, load_params_partial
from ..train.loop import eval_one_epoch, train_model
from ..train.metrics import MetricsLogger
from ..train.state import create_train_state
from ..utils.config import Config, cfg_from_list, cfg_from_yaml_file
from ..utils.device import resolve_device

REPO = Path(__file__).resolve().parents[2]


def create_logger(log_file=None):
    logger = logging.getLogger("modest_tpu_torch")
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s  %(levelname)5s  %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file is not None:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def load_model_config(cfg_file) -> Config:
    """The config of ``cfg_file``: the shipped dict when it names a shipped
    file, else the YAML file itself."""
    path = Path(cfg_file).resolve()
    for rel, cfg in SHIPPED_MODEL_CONFIGS.items():
        if path == REPO / rel:
            return Config(copy.deepcopy(cfg))
    return cfg_from_yaml_file(path)


def parse_config(argv=None):
    parser = argparse.ArgumentParser(description="train a detector")
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--extra_tag", type=str, default="default")
    parser.add_argument("--pretrained_model", type=str, default=None,
                        help="a .pth file (this package's or pcdet's) or a checkpoint "
                             "directory: a shape-checked partial load")
    parser.add_argument("--fix_random_seed", action="store_true")
    parser.add_argument("--workers", type=int, default=4,
                        help="batch-building worker processes; --fix_random_seed forces 0")
    parser.add_argument("--ckpt_save_interval", type=int, default=1)
    parser.add_argument("--max_ckpt_save_num", type=int, default=30)
    parser.add_argument("--merge_all_iters_to_one_epoch", action="store_true")
    parser.add_argument("--steps_per_dispatch", type=int, default=1,
                        help="accepted for the JAX CLI's sake: there it scans several steps "
                             "in one dispatch with results equal to single steps; here every "
                             "step is dispatched on its own")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="1 only: multi-device training is not ported")
    parser.add_argument("--launcher", choices=["none", "slurm", "manual"], default="none",
                        help="none only: multi-process training is not ported")
    parser.add_argument("--max_gt", type=int, default=64)
    parser.add_argument("--data_path", type=str, default=None,
                        help="override DATA_CONFIG.DATA_PATH")
    parser.add_argument("--output_dir", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--eval_after_train", action="store_true",
                        help="evaluate on the test split after training")
    parser.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    cfg = load_model_config(args.cfg_file)
    cfg.TAG = Path(args.cfg_file).stem
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs, cfg)
    if args.data_path is not None:
        cfg.DATA_CONFIG.DATA_PATH = args.data_path
    return args, cfg


def main(argv=None, stage_times: bool = False):
    """Train; returns the ``TrainState`` with ``history`` (the loop's per-step
    records) and ``start_epoch``. ``stage_times`` adds CUDA-event stage
    times to every step's record."""
    args, cfg = parse_config(argv)
    if args.launcher != "none" or (args.num_devices or 1) > 1:
        raise NotImplementedError("modest_tpu_torch trains in one process on one device; "
                                  "multi-process training is not ported")
    device = resolve_device(args.device)
    if args.fix_random_seed:
        np.random.seed(666)
        args.workers = 0

    out_root = (Path(args.output_dir) if args.output_dir
                else Path("output") / cfg.TAG / args.extra_tag)
    out_root.mkdir(parents=True, exist_ok=True)
    logger = create_logger(out_root / f"log_train_{datetime.datetime.now():%Y%m%d-%H%M%S}.txt")
    logger.info(f"config: {args.cfg_file}; output: {out_root}; device: {device}")

    batch_size = args.batch_size or int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    epochs = args.epochs or int(cfg.OPTIMIZATION.NUM_EPOCHS)
    train_set, train_loader = build_dataloader(
        cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size, training=True, logger=logger,
        total_epochs=epochs, merge_all_iters_to_one_epoch=args.merge_all_iters_to_one_epoch,
        max_gt=args.max_gt, num_workers=args.workers)
    # a merged loader already spans all epochs; otherwise an epoch is one pass
    total_steps = (len(train_loader) if args.merge_all_iters_to_one_epoch
                   else len(train_loader) * epochs)

    model = build_network(cfg.MODEL, num_class=len(cfg.CLASS_NAMES), device=device,
                          dataset=train_set)
    state = create_train_state(model, cfg.OPTIMIZATION, total_steps,
                               iters_per_epoch=len(train_loader))
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"model params: {n_params / 1e6:.2f}M, total steps: {total_steps}")

    manager = CheckpointManager(out_root / "ckpt", max_to_keep=args.max_ckpt_save_num)
    start_epoch = manager.restore(state) or 0
    if start_epoch:
        logger.info(f"resumed from epoch {start_epoch}")
    elif args.pretrained_model is not None:
        n_loaded, n_skipped = load_params_partial(model, args.pretrained_model, logger=logger)
        logger.info(f"pretrained transfer: {n_loaded} tensors loaded, {n_skipped} kept at init")

    metrics_logger = MetricsLogger(out_root)
    try:
        history = train_model(
            state, cfg.MODEL, train_loader, device=device, start_epoch=start_epoch,
            total_epochs=epochs, ckpt_manager=manager,
            ckpt_save_interval=args.ckpt_save_interval, logger=logger,
            merge_all_iters_to_one_epoch=args.merge_all_iters_to_one_epoch,
            metrics_logger=metrics_logger, stage_times=stage_times)
    finally:
        metrics_logger.close()
        train_loader.close()
    if manager.latest_epoch() != epochs:  # the interval saves may already cover it
        manager.save(state, epochs)
    logger.info("training finished")

    if args.eval_after_train:
        eval_set, eval_loader = build_dataloader(
            cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size, training=False, logger=logger,
            max_gt=args.max_gt, num_workers=args.workers)
        try:
            eval_one_epoch(model, cfg.MODEL, eval_loader, eval_set, cfg.CLASS_NAMES,
                           device=device, result_dir=out_root / "eval" / f"epoch_{epochs}" / "val",
                           logger=logger)
        finally:
            eval_loader.close()
    return dataclasses.replace(state, start_epoch=start_epoch, history=history)


if __name__ == "__main__":
    main()
