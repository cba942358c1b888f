"""CLI: the MODEST self-training loop (detect → PP-filter → merge → retrain) —
port of ``modest_tpu/cli/self_train.py``.

A Python driver in place of the reference's bash orchestration
(scripts/self_training_lyft.sh / self_training_nusc.sh) with the same
stage-skip-token resume:

  round i: combine_labels(prev result.pkl + seed boxes) → label dir
           → round dataset dir (symlinked sensors, fused label_2)
           → kitti infos + gt database
           → train (merge_all_iters_to_one_epoch, fixed seed)
           → infer on the TRAIN split → result.pkl for round i+1

A round whose ``eval_train/result.pkl`` exists is skipped whole; within a
round, the labels and the dataset are remade only without their
``.finish_tkn``. Every stage runs on ``--device`` (the card by default).
The model config comes from ``cli/train.py::load_model_config``, so the
shipped flagship config needs no YAML parser.

Usage:
  python -m modest_tpu_torch.cli.self_train --cfg_file <model.yaml> \\
      --base_data <kitti root> --work_dir <pipeline work dir> \\
      --seed_result <round-0 result.pkl> [--start_iter 1] [--max_iter 10] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import time
from pathlib import Path


def token(path) -> Path:
    return Path(path) / ".finish_tkn"


def make_round_dataset(base_data: Path, round_dir: Path, label_dir: Path):
    """Round dataset dir: symlink sensor dirs + ImageSets, point label_2 at
    the fused labels (reference self_training_lyft.sh:55-68)."""
    training = round_dir / "training"
    training.mkdir(parents=True, exist_ok=True)
    for sub in ["velodyne", "calib", "image_2", "planes", "oxts", "l2e"]:
        src = base_data / "training" / sub
        dst = training / sub
        if src.exists() and not dst.exists():
            os.symlink(src.resolve(), dst)
    for item in ["ImageSets", "kitti_infos_val.pkl"]:
        src = base_data / item
        dst = round_dir / item
        if src.exists() and not dst.exists():
            os.symlink(src.resolve(), dst)
    label_dst = training / "label_2"
    if label_dst.is_symlink():
        label_dst.unlink()
    os.symlink(Path(label_dir).resolve(), label_dst)


def main(argv=None):
    """Run the rounds; returns {round name: {stage: host seconds}} for the
    rounds this call ran (a finished round is skipped and absent)."""
    parser = argparse.ArgumentParser(description="MODEST self-training loop")
    parser.add_argument("--cfg_file", required=True)
    parser.add_argument("--base_data", required=True, help="round-0 KITTI dataset root")
    parser.add_argument("--work_dir", required=True,
                        help="pipeline work dir (holds intermediate_results/, meta_data/)")
    parser.add_argument("--seed_result", required=True,
                        help="round-0 detector result.pkl on the train split")
    parser.add_argument("--start_iter", type=int, default=1)
    parser.add_argument("--max_iter", type=int, default=10)
    parser.add_argument("--data_paths", default="fw70_2m")
    parser.add_argument("--rounds_dir", default=None,
                        help="where round datasets are created (default <base_data>_rounds)")
    parser.add_argument("--output_root", default="output/self_training")
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--num_devices", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="the device of every stage")
    parser.add_argument("--combine_overrides", nargs="*", default=[],
                        help="extra key=value overrides for combine_labels")
    parser.add_argument("--pretrained_model", default=None,
                        help="warm-start each round's training from a checkpoint "
                             "(a .pth file or a checkpoint directory)")
    args = parser.parse_args(argv)

    from . import combine_labels as combine_cli
    from . import test as test_cli
    from . import train as train_cli
    from ..data.kitti_dataset import create_kitti_infos
    from ..utils.device import resolve_device

    resolve_device(args.device)
    base_data = Path(args.base_data)
    work_dir = Path(args.work_dir)
    rounds_dir = Path(args.rounds_dir) if args.rounds_dir else base_data.parent / (
        base_data.name + "_rounds")
    output_root = Path(args.output_root)
    prev_result = Path(args.seed_result)
    timings = {}

    for i in range(args.start_iter, args.max_iter + 1):
        iter_name = f"round_{i}"
        round_out = output_root / iter_name
        final_result = round_out / "eval_train" / "result.pkl"
        if final_result.exists():
            print(f"=> {iter_name} has finished")
            prev_result = final_result
            continue
        times = timings[iter_name] = {}

        # 1. fuse previous detections with seed boxes
        t0 = time.perf_counter()
        label_dir = work_dir / "intermediate_results" / f"{iter_name}_labels"
        if not token(label_dir).exists():
            print(f"=> generating {iter_name} labels")
            combine_cli.main([
                f"work_dir={work_dir}",
                f"data_paths={args.data_paths}",
                f"data_root={base_data}/training",
                "fov_only=true",
                f"det_result_path={prev_result}",
                f"save_path={label_dir}",
                f"device={args.device}",
            ] + list(args.combine_overrides))
            token(label_dir).touch()
        else:
            print(f"=> skipping {iter_name} labels")
        times["combine"] = time.perf_counter() - t0

        # 2. round dataset
        t0 = time.perf_counter()
        round_data = rounds_dir / iter_name
        make_round_dataset(base_data, round_data, label_dir)
        times["round_dataset"] = time.perf_counter() - t0

        # 3. infos + gt database
        t0 = time.perf_counter()
        if not token(round_data).exists():
            print(f"=> preprocessing {iter_name} dataset")
            cfg = train_cli.load_model_config(args.cfg_file)
            create_kitti_infos(cfg.DATA_CONFIG, cfg.CLASS_NAMES, round_data, round_data,
                               if_val=False)
            token(round_data).touch()
        times["infos"] = time.perf_counter() - t0

        # 4. train
        t0 = time.perf_counter()
        print(f"=> {iter_name} training")
        train_args = [
            "--cfg_file", args.cfg_file,
            "--extra_tag", iter_name,
            "--merge_all_iters_to_one_epoch",
            "--fix_random_seed",
            "--data_path", str(round_data),
            "--output_dir", str(round_out),
            "--device", args.device,
        ]
        if args.batch_size:
            train_args += ["--batch_size", str(args.batch_size)]
        if args.epochs:
            train_args += ["--epochs", str(args.epochs)]
        if args.pretrained_model:
            train_args += ["--pretrained_model", str(args.pretrained_model)]
        if args.num_devices:
            train_args += ["--num_devices", str(args.num_devices)]
        train_cli.main(train_args)
        times["train"] = time.perf_counter() - t0

        # 5. inference on the TRAIN split → next round's pseudo labels
        t0 = time.perf_counter()
        print(f"=> {iter_name} train-split inference")
        test_args = [
            "--cfg_file", args.cfg_file,
            "--ckpt_dir", str(round_out / "ckpt"),
            "--data_path", str(round_data),
            "--output_dir", str(round_out / "eval_train_root"),
            "--device", args.device,
        ]
        if args.batch_size:
            test_args += ["--batch_size", str(args.batch_size)]
        if args.num_devices:
            test_args += ["--num_devices", str(args.num_devices)]
        # --set stays last (REMAINDER)
        test_cli.main(test_args + ["--set", "DATA_CONFIG.DATA_SPLIT.test", "train",
                                   "DATA_CONFIG.INFO_PATH.test", "[kitti_infos_train.pkl]"])
        times["inference"] = time.perf_counter() - t0
        # normalise the result's place (numeric epoch sort: 'epoch_10' > 'epoch_9')
        produced = sorted(
            (round_out / "eval_train_root").glob("eval/epoch_*/train/result.pkl"),
            key=lambda p: int(p.parent.parent.name.split("_")[-1]))
        if not produced:
            raise RuntimeError(f"{iter_name}: train-split inference produced no result.pkl")
        final_result.parent.mkdir(parents=True, exist_ok=True)
        if final_result.exists():
            final_result.unlink()
        os.link(produced[-1], final_result)
        prev_result = final_result
        print(f"=> {iter_name} done: {final_result}")
    return timings


if __name__ == "__main__":
    main()
