"""Host-side per-sample processors — port of ``modest_tpu/data/processor.py``
(reference pcdet/datasets/processor/).

numpy, before batching; ``sample_points`` makes every sample a fixed
(NUM_POINTS, 4) array, so a batch stacks into one dense tensor. The steps
draw from ``np.random`` in the JAX package's order. The grid detectors
voxelize on the device (``models/voxelize.py``): ``transform_points_to_voxels``
and ``calculate_grid_size`` only record the grid here. The camera model's
depth-map step is not ported and raises ``NotImplementedError``.
"""
from __future__ import annotations

import numpy as np

from ..utils import box_np


def mask_points_and_boxes_outside_range(data_dict, point_cloud_range,
                                        remove_outside_boxes=True, training=True,
                                        min_num_corners=1):
    if data_dict.get("points") is not None:
        mask = box_np.mask_points_by_range(data_dict["points"], point_cloud_range)
        data_dict["points"] = data_dict["points"][mask]
    if data_dict.get("gt_boxes") is not None and remove_outside_boxes and training:
        if len(data_dict["gt_boxes"]) > 0:
            mask = box_np.mask_boxes_outside_range(
                data_dict["gt_boxes"], point_cloud_range, min_num_corners
            )
            data_dict["gt_boxes"] = data_dict["gt_boxes"][mask]
            if "gt_names" in data_dict:
                data_dict["gt_names"] = data_dict["gt_names"][mask]
    return data_dict


def shuffle_points(data_dict, enabled=True):
    if enabled:
        idx = np.random.permutation(data_dict["points"].shape[0])
        data_dict["points"] = data_dict["points"][idx]
    return data_dict


def sample_points(data_dict, num_points: int):
    """Near/far-aware resampling to a fixed count (reference
    data_processor.sample_points:82-118)."""
    if num_points == -1:
        return data_dict
    points = data_dict["points"]
    if len(points) == 0:
        # the reference crashes in np.random.choice here; without this guard
        # the wrap-around loop below would spin forever on an empty cloud
        raise ValueError(
            f"sample_points: empty point cloud for frame "
            f"{data_dict.get('frame_id')!r} — all points were filtered out "
            f"before sampling {num_points}")
    if num_points < len(points):
        # squared-depth compare (norm's sqrt is a full extra pass at 90k pts)
        d2 = (points[:, 0:3] ** 2).sum(axis=1)
        near = d2 < 40.0 * 40.0
        far_idx = np.where(~near)[0]
        near_idx = np.where(near)[0]
        if num_points > len(far_idx):
            near_choice = np.random.choice(near_idx, num_points - len(far_idx), replace=False)
            choice = (
                np.concatenate((near_choice, far_idx)) if len(far_idx) > 0 else near_choice
            )
        else:
            choice = np.random.choice(np.arange(len(points), dtype=np.int32),
                                      num_points, replace=False)
        np.random.shuffle(choice)
    else:
        choice = np.arange(0, len(points), dtype=np.int32)
        while num_points > len(choice):
            extra = np.random.choice(
                len(points), min(len(points), num_points - len(choice)), replace=False
            )
            choice = np.concatenate((choice, extra))
        np.random.shuffle(choice)
    data_dict["points"] = points[choice]
    return data_dict


class PointFeatureEncoder:
    """absolute_coordinates_encoding (reference point_feature_encoder.py)."""

    def __init__(self, cfg):
        assert cfg.encoding_type == "absolute_coordinates_encoding"
        self.used_feature_list = list(cfg.used_feature_list)
        self.src_feature_list = list(cfg.src_feature_list)
        assert self.src_feature_list[0:3] == ["x", "y", "z"]

    @property
    def num_point_features(self) -> int:
        return len(self.used_feature_list)

    def __call__(self, data_dict):
        points = data_dict["points"]
        keep = [0, 1, 2]
        for f in self.used_feature_list:
            if f in ("x", "y", "z"):
                continue
            keep.append(self.src_feature_list.index(f))
        data_dict["points"] = points[:, keep]
        data_dict["use_lead_xyz"] = True
        return data_dict


class DataProcessor:
    """Sequenced processors from DATA_PROCESSOR config list."""

    def __init__(self, processor_cfgs, point_cloud_range, training: bool):
        self.point_cloud_range = np.asarray(point_cloud_range, np.float32)
        self.training = training
        self.mode = "train" if training else "test"
        self.grid_size = None
        self.voxel_size = None
        self.steps = []
        for cfg in processor_cfgs:
            if cfg.NAME not in ("mask_points_and_boxes_outside_range", "shuffle_points",
                                "sample_points", "transform_points_to_voxels",
                                "calculate_grid_size"):
                raise NotImplementedError(f"modest_tpu_torch: processor {cfg.NAME} is not ported")
            self.steps.append((cfg.NAME, cfg))
            if cfg.NAME in ("transform_points_to_voxels", "calculate_grid_size"):
                grid = (self.point_cloud_range[3:6] - self.point_cloud_range[0:3]) / np.array(
                    cfg.VOXEL_SIZE)
                self.grid_size = np.round(grid).astype(np.int64)
                self.voxel_size = list(cfg.VOXEL_SIZE)

    def __call__(self, data_dict):
        for name, cfg in self.steps:
            if name == "mask_points_and_boxes_outside_range":
                data_dict = mask_points_and_boxes_outside_range(
                    data_dict, self.point_cloud_range,
                    remove_outside_boxes=cfg.get("REMOVE_OUTSIDE_BOXES", True),
                    training=self.training,
                )
            elif name == "shuffle_points":
                data_dict = shuffle_points(data_dict, cfg.SHUFFLE_ENABLED[self.mode])
            elif name == "sample_points":
                data_dict = sample_points(data_dict, int(cfg.NUM_POINTS[self.mode]))
            elif name == "transform_points_to_voxels":
                # the grid is in __init__; the caps are recorded as the JAX package does
                data_dict["max_voxels"] = int(cfg.MAX_NUMBER_OF_VOXELS[self.mode])
                data_dict["max_points_per_voxel"] = int(cfg.MAX_POINTS_PER_VOXEL)
        return data_dict
