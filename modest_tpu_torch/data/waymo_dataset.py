"""Native Waymo Open Dataset reader (per-sequence infos + npy point files) —
port of ``modest_tpu/data/waymo_dataset.py``.

Reference: pcdet/datasets/waymo/{waymo_dataset,waymo_utils,waymo_eval}.py
(846 LoC). Loading processed sequences (npy point files + per-sequence info
pkls) is SDK-free; extracting them from TFRecords and the official LET/AP
metric need `waymo_open_dataset` + tensorflow and are gated on import. The
kitti-style AP path (the reference's EVAL_METRIC=kitti branch) is available
SDK-free via eval.kitti_eval.ap_from_lidar_annos.

Processed layout (identical to the reference's on-disk contract):
  <root>/<PROCESSED_DATA_TAG>/<sequence_name>/<sequence_name>.pkl   infos
  <root>/<PROCESSED_DATA_TAG>/<sequence_name>/0000.npy              points
  npy rows: [x, y, z, intensity, elongation, NLZ_flag]
"""
from __future__ import annotations

import copy
import pickle
from pathlib import Path

import numpy as np

from ..utils.config import Config
from .augmentor import DataAugmentor
from .processor import DataProcessor, PointFeatureEncoder


class WaymoDataset:
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None):
        self.dataset_cfg = Config(dataset_cfg)
        self.class_names = list(class_names)
        self.training = training
        self.root_path = Path(root_path if root_path is not None
                              else self.dataset_cfg.DATA_PATH)
        self.logger = logger
        self.mode = "train" if training else "test"
        self._merge_all_iters_to_one_epoch = False
        self.total_epochs = 1

        self.data_path = self.root_path / self.dataset_cfg.PROCESSED_DATA_TAG
        self.split = self.dataset_cfg.DATA_SPLIT[self.mode]
        split_file = self.root_path / "ImageSets" / f"{self.split}.txt"
        self.sample_sequence_list = [
            x.strip() for x in open(split_file).readlines()
        ] if split_file.exists() else []

        pcr = np.asarray(self.dataset_cfg.POINT_CLOUD_RANGE, np.float32)
        self.point_cloud_range = pcr
        self.point_feature_encoder = PointFeatureEncoder(
            self.dataset_cfg.POINT_FEATURE_ENCODING
        )
        aug_cfg = self.dataset_cfg.get("DATA_AUGMENTOR", None)
        self.data_augmentor = (
            DataAugmentor(self.root_path, aug_cfg, self.class_names, logger=logger)
            if training and aug_cfg is not None else None
        )
        self.data_processor = DataProcessor(
            self.dataset_cfg.DATA_PROCESSOR, point_cloud_range=pcr, training=training
        )
        self.grid_size = self.data_processor.grid_size
        self.voxel_size = self.data_processor.voxel_size
        if self.grid_size is None and self.dataset_cfg.get("VOXEL_SIZE", None):
            vs = np.asarray(self.dataset_cfg.VOXEL_SIZE, np.float64)
            self.voxel_size = list(self.dataset_cfg.VOXEL_SIZE)
            self.grid_size = np.round((pcr[3:6] - pcr[0:3]) / vs).astype(np.int64)

        self.infos = []
        self.include_waymo_data(self.mode)

    def include_waymo_data(self, mode):
        """Concatenate per-sequence info pkls; SAMPLED_INTERVAL subsampling
        (reference waymo_dataset.py:44-70)."""
        infos, skipped = [], 0
        for seq_file in self.sample_sequence_list:
            name = Path(seq_file).stem.replace(".tfrecord", "")
            p = self.data_path / name / f"{name}.pkl"
            if not p.exists():
                skipped += 1
                continue
            with open(p, "rb") as f:
                infos.extend(pickle.load(f))
        self.infos.extend(infos)
        if self.logger:
            self.logger.info(
                f"Total samples for Waymo dataset: {len(infos)} (skipped {skipped})"
            )
        interval = int(self.dataset_cfg.SAMPLED_INTERVAL[mode])
        if interval > 1:
            self.infos = self.infos[::interval]
            if self.logger:
                self.logger.info(f"Total sampled samples: {len(self.infos)}")

    def get_lidar(self, sequence_name, sample_idx):
        """npy → (N, 5) [x y z tanh(intensity) elongation], NLZ dropped
        (reference waymo_dataset.py:102-109)."""
        f = self.data_path / sequence_name / f"{sample_idx:04d}.npy"
        feats = np.load(f)
        points, nlz = feats[:, 0:5], feats[:, 5]
        points = points[nlz == -1]
        points[:, 3] = np.tanh(points[:, 3])
        return points

    def __len__(self):
        if self._merge_all_iters_to_one_epoch:
            return len(self.infos) * self.total_epochs
        return len(self.infos)

    def merge_all_iters_to_one_epoch(self, merge=True, epochs=None):
        self._merge_all_iters_to_one_epoch = merge
        self.total_epochs = epochs or 1

    def __getitem__(self, index):
        if self._merge_all_iters_to_one_epoch:
            index = index % len(self.infos)
        info = copy.deepcopy(self.infos[index])
        pc_info = info["point_cloud"]
        points = self.get_lidar(pc_info["lidar_sequence"], pc_info["sample_idx"])
        input_dict = {"points": points, "frame_id": info["frame_id"]}
        if "annos" in info:
            annos = info["annos"]
            keep = np.asarray(annos["name"]) != "unknown"
            input_dict["gt_names"] = np.asarray(annos["name"])[keep]
            input_dict["gt_boxes"] = np.asarray(annos["gt_boxes_lidar"])[keep]
        data_dict = self.prepare_data(input_dict)
        data_dict["metadata"] = info.get("metadata", info["frame_id"])
        return data_dict

    def prepare_data(self, data_dict):
        if self.training and self.data_augmentor is not None:
            mask = np.array([n in self.class_names for n in data_dict["gt_names"]], bool)
            data_dict = self.data_augmentor({**data_dict, "gt_boxes_mask": mask})
        if data_dict.get("gt_boxes") is not None:
            selected = [i for i, n in enumerate(data_dict["gt_names"])
                        if n in self.class_names]
            data_dict["gt_boxes"] = np.asarray(data_dict["gt_boxes"])[selected]
            data_dict["gt_names"] = np.asarray(data_dict["gt_names"])[selected]
            gt_classes = np.array(
                [self.class_names.index(n) + 1 for n in data_dict["gt_names"]], np.int32
            )
            data_dict["gt_boxes"] = np.concatenate(
                [data_dict["gt_boxes"].astype(np.float32)[:, :7],
                 gt_classes.reshape(-1, 1).astype(np.float32)], axis=1,
            )
        data_dict = self.point_feature_encoder(data_dict)
        data_dict = self.data_processor(data_dict)
        if self.training and data_dict.get("gt_boxes") is not None \
                and len(data_dict["gt_boxes"]) == 0:
            return self.__getitem__(np.random.randint(len(self)))
        data_dict.pop("gt_names", None)
        return data_dict

    @staticmethod
    def generate_prediction_dicts(batch_dict, pred_dicts, class_names,
                                  output_path=None):
        annos = []
        for index, box_dict in enumerate(pred_dicts):
            scores = np.asarray(box_dict["pred_scores"]).reshape(-1)
            boxes = np.asarray(box_dict["pred_boxes"]).reshape(-1, box_dict["pred_boxes"].shape[-1])
            labels = np.asarray(box_dict["pred_labels"]).reshape(-1).astype(np.int64)
            annos.append({
                "name": (np.array(class_names)[labels - 1]
                         if len(scores) else np.zeros(0)),
                "score": scores,
                "boxes_lidar": boxes,
                "frame_id": batch_dict["frame_id"][index],
                "metadata": batch_dict.get("metadata", [None] * (index + 1))[index],
            })
        return annos

    def evaluation(self, det_annos, class_names, **kwargs):
        """'waymo' → SDK-free AP/APH L1/L2 (eval.waymo_eval reimplements the
        reference's TF detection-metrics binding, waymo_eval.py:85-257);
        'kitti' → lidar-frame R40 AP (reference :199-250)."""
        if "annos" not in self.infos[0]:
            return "No ground-truth boxes for evaluation", {}
        metric = self.dataset_cfg.get("EVAL_METRIC", "kitti")
        if metric == "waymo":
            from ..eval.waymo_eval import (format_waymo_results,
                                           waymo_detection_metrics)

            gt_annos = [
                {"name": np.asarray(info["annos"]["name"]),
                 "gt_boxes_lidar": np.asarray(info["annos"]["gt_boxes_lidar"])[:, :7],
                 **({"num_points_in_gt":
                     np.asarray(info["annos"]["num_points_in_gt"])}
                    if "num_points_in_gt" in info["annos"] else {}),
                 **({"difficulty": np.asarray(info["annos"]["difficulty"])}
                    if "difficulty" in info["annos"] else {})}
                for info in self.infos
            ]
            res = waymo_detection_metrics(det_annos, gt_annos, class_names)
            return format_waymo_results(res), res
        gt_annos = [
            {"name": np.asarray(info["annos"]["name"]),
             "boxes_lidar": np.asarray(info["annos"]["gt_boxes_lidar"])[:, :7]}
            for info in self.infos
        ]
        from ..eval.kitti_eval import ap_from_lidar_annos

        return ap_from_lidar_annos(gt_annos, det_annos, class_names)

    def create_groundtruth_database(self, info_path=None, used_classes=None,
                                    split="train", sampled_interval=10):
        """Crop per-GT points into pcdet_gt_database_* (reference :252-307)."""
        from ..utils.box_np import points_in_boxes_mask

        db_path = self.root_path / f"pcdet_gt_database_{split}_sampled_{sampled_interval}"
        db_info_path = self.root_path / f"pcdet_waymo_dbinfos_{split}_sampled_{sampled_interval}.pkl"
        db_path.mkdir(parents=True, exist_ok=True)
        all_db_infos = {}
        for k in range(0, len(self.infos), sampled_interval):
            info = self.infos[k]
            if "annos" not in info:
                continue
            pc_info = info["point_cloud"]
            points = self.get_lidar(pc_info["lidar_sequence"], pc_info["sample_idx"])
            annos = info["annos"]
            names = np.asarray(annos["name"])
            gt_boxes = np.asarray(annos["gt_boxes_lidar"], np.float32)
            if len(gt_boxes) == 0:
                continue
            # the reference's db info carries each box's difficulty, which
            # gt_sampling's filter_by_difficulty reads
            difficulty = np.asarray(annos.get("difficulty", np.zeros(len(gt_boxes), np.int64)))
            inside = points_in_boxes_mask(points, gt_boxes[:, :7])  # (M, N)
            for i in range(len(gt_boxes)):
                name = str(names[i])
                if name == "unknown" or (used_classes and name not in used_classes):
                    continue
                gt_points = points[inside[i]]
                if gt_points.shape[0] == 0:
                    continue
                gt_points = gt_points.copy()
                gt_points[:, :3] -= gt_boxes[i, :3]
                filename = f"{pc_info['lidar_sequence']}_{pc_info['sample_idx']}_{name}_{i}.bin"
                gt_points.astype(np.float32).tofile(db_path / filename)
                all_db_infos.setdefault(name, []).append({
                    "name": name,
                    "path": str((db_path / filename).relative_to(self.root_path)),
                    "sequence_name": pc_info["lidar_sequence"],
                    "sample_idx": pc_info["sample_idx"],
                    "gt_idx": i,
                    "box3d_lidar": gt_boxes[i, :7],
                    "num_points_in_gt": gt_points.shape[0],
                    "difficulty": int(difficulty[i]),
                })
        with open(db_info_path, "wb") as f:
            pickle.dump(all_db_infos, f)
        return db_info_path


def process_single_sequence(sequence_file, save_path, sampled_interval=1,
                            has_label=True):
    """TFRecord → per-frame npy + sequence info pkl. Requires tensorflow +
    waymo_open_dataset (reference waymo_utils.process_single_sequence)."""
    try:
        import tensorflow as tf
        from waymo_open_dataset import dataset_pb2
        from waymo_open_dataset.utils import frame_utils, transform_utils  # noqa: F401
    except ImportError as e:  # pragma: no cover — SDK not in image
        raise ImportError(
            "Waymo TFRecord extraction requires tensorflow + "
            "waymo_open_dataset; sequences processed on any host with "
            "them are loadable here without either"
        ) from e

    sequence_name = Path(sequence_file).stem.replace(".tfrecord", "")
    out_dir = Path(save_path) / sequence_name
    out_dir.mkdir(parents=True, exist_ok=True)
    infos = []
    dataset = tf.data.TFRecordDataset(str(sequence_file), compression_type="")
    for cnt, data in enumerate(dataset):  # pragma: no cover
        if cnt % sampled_interval != 0:
            continue
        frame = dataset_pb2.Frame()
        frame.ParseFromString(bytearray(data.numpy()))
        ri, cp, _, ri_pose = frame_utils.parse_range_image_and_camera_projection(frame)
        # keep_polar_features → rows [range, intensity, elongation, x, y, z]
        # (first return only), matching the reference's real feature extraction
        # (waymo_utils.save_lidar_points channels 1/2); the NLZ flag is range
        # image channel 3, gathered under the same range>0 mask and laser
        # order (sorted by name) frame_utils uses internally.
        points, cp_points = frame_utils.convert_range_image_to_point_cloud(
            frame, ri, cp, ri_pose, keep_polar_features=True
        )
        polar = np.concatenate(points, axis=0).astype(np.float32)
        pts, intensity, elongation = polar[:, 3:6], polar[:, 1], polar[:, 2]
        nlz_parts = []
        for calib in sorted(frame.context.laser_calibrations, key=lambda c: c.name):
            ri0 = ri[calib.name][0]
            ri_np = np.asarray(
                tf.reshape(tf.convert_to_tensor(ri0.data), ri0.shape.dims)
            )
            nlz_parts.append(ri_np[..., 3][ri_np[..., 0] > 0])
        nlz = np.concatenate(nlz_parts).astype(np.float32)
        assert nlz.shape[0] == pts.shape[0], (nlz.shape, pts.shape)
        feats = np.concatenate(
            [pts, intensity[:, None], elongation[:, None], nlz[:, None]], axis=1
        )
        np.save(out_dir / f"{cnt:04d}.npy", feats)
        info = {
            "point_cloud": {"lidar_sequence": sequence_name, "sample_idx": cnt},
            "frame_id": f"{sequence_name}_{cnt:03d}",
            "metadata": {"context_name": frame.context.name,
                         "timestamp_micros": frame.timestamp_micros},
        }
        if has_label:
            names, boxes = [], []
            type_map = {1: "Vehicle", 2: "Pedestrian", 3: "Sign", 4: "Cyclist"}
            for obj in frame.laser_labels:
                b = obj.box
                names.append(type_map.get(obj.type, "unknown"))
                boxes.append([b.center_x, b.center_y, b.center_z,
                              b.length, b.width, b.height, b.heading])
            info["annos"] = {
                "name": np.asarray(names),
                "gt_boxes_lidar": np.asarray(boxes, np.float32).reshape(-1, 7),
            }
        infos.append(info)
    with open(out_dir / f"{sequence_name}.pkl", "wb") as f:
        pickle.dump(infos, f)
    return infos


if __name__ == "__main__":
    # python -m modest_tpu_torch.data.waymo_dataset create_waymo_infos \
    #     --raw_data data/waymo/raw_data --save_path data/waymo/waymo_processed_data
    # (reference: python -m pcdet.datasets.waymo.waymo_dataset)
    import argparse
    import sys

    if len(sys.argv) > 1 and sys.argv[1] == "create_waymo_infos":
        parser = argparse.ArgumentParser()
        parser.add_argument("func")
        parser.add_argument("--raw_data", required=True)
        parser.add_argument("--save_path", required=True)
        parser.add_argument("--sampled_interval", type=int, default=1)
        args = parser.parse_args()
        for seq in sorted(Path(args.raw_data).glob("*.tfrecord")):
            process_single_sequence(
                seq, args.save_path, sampled_interval=args.sampled_interval
            )
