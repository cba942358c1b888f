"""CLI: offline KITTI-format evaluation of a label directory against ground
truth — port of ``modest_tpu/cli/evaluate.py`` (reference
kitti_object_eval_python/evaluate.py, argparse instead of fire). Host only.

Usage:
  python -m modest_tpu_torch.cli.evaluate --label_path <gt label_2 dir> \
      --result_path <detection label dir> --label_split_file <ids.txt> \
      [--current_class Dynamic] [--metric official|coco|range] \
      [--score_thresh -1]

Evaluates seed labels, fused self-training labels, or any saved detection
txt directory against a KITTI gt directory without running a model.
"""
from __future__ import annotations

import argparse
import re
from pathlib import Path

import numpy as np


def get_label_annos(label_folder, image_ids=None):
    """KITTI label txt dir → list of eval-format annos (reference
    kitti_common.get_label_annos; dimensions hwl → lhw camera order)."""
    folder = Path(label_folder)
    if image_ids is None:
        prog = re.compile(r"^\d{6}\.txt$")
        image_ids = sorted(int(p.stem) for p in folder.glob("*.txt")
                           if prog.match(p.name))
    annos = []
    for idx in image_ids:
        path = folder / f"{int(idx):06d}.txt"
        content = []
        if path.exists():
            with open(path) as f:
                content = [ln.split() for ln in f if ln.strip()]
        anno = {
            "name": np.array([x[0] for x in content]),
            "truncated": np.array([float(x[1]) for x in content]),
            "occluded": np.array([int(float(x[2])) for x in content]),
            "alpha": np.array([float(x[3]) for x in content]),
            "bbox": np.array([[float(v) for v in x[4:8]] for x in content]
                             ).reshape(-1, 4),
            "dimensions": np.array([[float(v) for v in x[8:11]] for x in content]
                                   ).reshape(-1, 3)[:, [2, 0, 1]],
            "location": np.array([[float(v) for v in x[11:14]] for x in content]
                                 ).reshape(-1, 3),
            "rotation_y": np.array([float(x[14]) for x in content]).reshape(-1),
        }
        if content and len(content[0]) == 16:
            anno["score"] = np.array([float(x[15]) for x in content])
        else:
            anno["score"] = np.zeros(len(content))
        annos.append(anno)
    return annos


def filter_annos_low_score(annos, thresh):
    out = []
    for anno in annos:
        keep = anno["score"] > thresh
        out.append({k: (v[keep] if isinstance(v, np.ndarray) and
                        v.shape[:1] == keep.shape else v)
                    for k, v in anno.items()})
    return out


def main(argv=None):
    from ..eval.kitti_eval import (
        get_coco_eval_result,
        get_official_eval_result,
        get_range_eval_result,
    )

    parser = argparse.ArgumentParser(description="offline KITTI label eval")
    parser.add_argument("--label_path", required=True, help="gt label dir")
    parser.add_argument("--result_path", required=True, help="det label dir")
    parser.add_argument("--label_split_file", default=None,
                        help="ImageSets txt of frame ids (default: every "
                             "txt in label_path)")
    parser.add_argument("--current_class", default="Dynamic",
                        help="class name (e.g. Dynamic, Car) or int id")
    parser.add_argument("--metric", default="range",
                        choices=["official", "coco", "range"],
                        help="range = the MODEST range-bucketed report")
    parser.add_argument("--score_thresh", type=float, default=-1)
    args = parser.parse_args(argv)

    if args.label_split_file:
        with open(args.label_split_file) as f:
            ids = [int(ln) for ln in f if ln.strip()]
    else:
        # derive ids from the GT dir once and use them for BOTH dirs —
        # independent globbing could silently pair mismatched frames
        prog = re.compile(r"^\d{6}\.txt$")
        ids = sorted(int(p.stem) for p in Path(args.label_path).glob("*.txt")
                     if prog.match(p.name))
    gt_annos = get_label_annos(args.label_path, ids)
    dt_annos = get_label_annos(args.result_path, ids)
    if args.score_thresh > 0:
        dt_annos = filter_annos_low_score(dt_annos, args.score_thresh)

    cls = args.current_class
    cls = int(cls) if str(cls).isdigit() else cls
    fn = {"official": get_official_eval_result,
          "coco": get_coco_eval_result,
          "range": get_range_eval_result}[args.metric]
    result_str, result_dict = fn(gt_annos, dt_annos, cls)
    print(result_str)
    return result_dict


if __name__ == "__main__":
    main()
