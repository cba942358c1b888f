"""CLI: detect on raw point-cloud files — port of ``modest_tpu/cli/demo.py``
(reference tools/demo.py).

Usage:
  python -m modest_tpu_torch.cli.demo --cfg_file <model.yaml> [--ckpt_dir <dir>] \\
      --data_path <file-or-dir> [--ext .bin] [--save_dir <dir>] [--device cpu] [--set KEY VALUE ...]

Reads ``.bin`` (float32 × the config's source features) or ``.npy`` point
files, runs each through the config's eval-time point encoding and
processors and the detector's eval forward and post-processing, one frame a
batch, and prints the boxes; with ``--save_dir`` it renders a BEV PNG per
frame (``utils/visualize.py::plot_bev``, which needs matplotlib). Without
``--ckpt_dir`` the weights are random. The shipped configs
(``configs.SHIPPED_MODEL_CONFIGS``) need no YAML parser. Runs on the card
unless ``--device cpu``; without CUDA the default raises. CaDDN, a camera
model, is refused, as in the JAX package.
"""
from __future__ import annotations

import argparse
import glob
from pathlib import Path

import numpy as np

from ..data.loader import batch_to_device, collate_batch
from ..data.processor import DataProcessor, PointFeatureEncoder
from ..models import api, build_network
from ..train.checkpoint import CheckpointManager
from ..train.loop import _trim_predictions
from ..utils.config import cfg_from_list
from ..utils.device import resolve_device
from .train import load_model_config


class DemoDataset:
    """File-list dataset: raw points through the config's eval-time pipeline
    (reference tools/demo.py DemoDataset)."""

    def __init__(self, dataset_cfg, class_names, root_path, ext=".bin"):
        self.dataset_cfg = dataset_cfg
        self.class_names = class_names
        self.ext = ext
        root = Path(root_path)
        files = sorted(glob.glob(str(root / f"*{ext}"))) if root.is_dir() else [str(root)]
        if not files:
            raise FileNotFoundError(f"no *{ext} files under {root}")
        self.sample_file_list = files
        self.point_feature_encoder = PointFeatureEncoder(dataset_cfg.POINT_FEATURE_ENCODING)
        self.data_processor = DataProcessor(dataset_cfg.DATA_PROCESSOR,
                                            dataset_cfg.POINT_CLOUD_RANGE, training=False)
        self.grid_size = self.data_processor.grid_size
        self.voxel_size = self.data_processor.voxel_size
        self.point_cloud_range = np.asarray(dataset_cfg.POINT_CLOUD_RANGE, np.float32)

    def __len__(self):
        return len(self.sample_file_list)

    def __getitem__(self, index):
        path = self.sample_file_list[index]
        src = len(self.dataset_cfg.POINT_FEATURE_ENCODING.src_feature_list)
        if self.ext == ".bin":
            points = np.fromfile(path, dtype=np.float32).reshape(-1, src)
        elif self.ext == ".npy":
            points = np.load(path).astype(np.float32)
        else:
            raise NotImplementedError(self.ext)
        data_dict = self.point_feature_encoder({"points": points, "frame_id": Path(path).stem})
        return self.data_processor(data_dict)


def main(argv=None):
    """Detect on every file; returns one dict per frame: frame_id, boxes (K,
    7), scores (K,), labels (K,)."""
    parser = argparse.ArgumentParser(description="detect on raw point-cloud files")
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--ckpt_dir", type=str, default=None,
                        help="checkpoint directory; random weights without it")
    parser.add_argument("--ckpt_epoch", type=int, default=None)
    parser.add_argument("--data_path", type=str, required=True,
                        help="a point-cloud file or a directory of them")
    parser.add_argument("--ext", type=str, default=".bin", choices=[".bin", ".npy"])
    parser.add_argument("--save_dir", type=str, default=None,
                        help="write <frame_id>.png BEV renders here")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    cfg = load_model_config(args.cfg_file)
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs, cfg)
    if str(cfg.MODEL.get("NAME", "")) == "CaDDN":
        raise SystemExit("demo.py is lidar-only; CaDDN needs camera inputs "
                         "(use cli.test with a KITTI-format dir)")
    device = resolve_device(args.device)

    dataset = DemoDataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, args.data_path, args.ext)
    print(f"total samples: {len(dataset)}")
    model = build_network(cfg.MODEL, num_class=len(cfg.CLASS_NAMES), device=device,
                          dataset=dataset)
    if args.ckpt_dir is not None:
        epoch = CheckpointManager(args.ckpt_dir).restore_model(model, args.ckpt_epoch)
        if epoch is None:
            raise FileNotFoundError(f"no checkpoint found in {args.ckpt_dir}")
        print(f"loaded epoch {epoch} from {args.ckpt_dir}")
    else:
        print("WARNING: no --ckpt_dir: running with randomly initialised weights")
    save_dir = Path(args.save_dir) if args.save_dir else None
    if save_dir is not None:
        save_dir.mkdir(parents=True, exist_ok=True)

    results = []
    for i in range(len(dataset)):
        batch = collate_batch([dataset[i]])
        points = batch_to_device(batch, device)["points"]
        final = api.post_process(api.apply_eval(model, cfg.MODEL, points), cfg.MODEL)
        preds = _trim_predictions(final)[0]
        frame_id = batch["frame_id"][0]
        boxes = preds["pred_boxes"].reshape(-1, preds["pred_boxes"].shape[-1])[:, :7]
        scores, labels = preds["pred_scores"].reshape(-1), preds["pred_labels"].reshape(-1)
        print(f"[{i + 1}/{len(dataset)}] {frame_id}: {len(boxes)} detections")
        for b, s, lb in zip(boxes, scores, labels):
            name = cfg.CLASS_NAMES[lb - 1] if 0 < lb <= len(cfg.CLASS_NAMES) else str(lb)
            print(f"  {name} score={s:.3f} xyz=({b[0]:.2f},{b[1]:.2f},{b[2]:.2f}) "
                  f"lwh=({b[3]:.2f},{b[4]:.2f},{b[5]:.2f}) ry={b[6]:.2f}")
        if save_dir is not None:
            from ..utils.visualize import plot_bev

            plot_bev(batch["points"][0], boxes, save_path=save_dir / f"{frame_id}.png")
        results.append({"frame_id": frame_id, "boxes": boxes, "scores": scores,
                        "labels": labels})
    print("demo done.")
    return results


if __name__ == "__main__":
    main()
