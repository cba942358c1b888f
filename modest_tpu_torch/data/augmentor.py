"""Training-time augmentation — port of ``modest_tpu/data/augmentor.py``
(reference pcdet/datasets/augmentor/).

gt_sampling pastes database object crops into the scene (road-plane snapped,
BEV-collision rejected); world flip/rotation/scaling follow. Host-side numpy,
drawing from ``np.random`` in the JAX package's order, so one seed gives the
same scenes. CaDDN's ``random_image_flip`` flips the image, the depth map
and the 2D boxes and mirrors the 3D boxes through the image plane.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from ..utils import box_np


def _bev_iou_cpu(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Rotated BEV IoU on the host (native C++ library; ``ops/iou3d.py``
    where it cannot be built)."""
    from ..utils import native

    if boxes_a.shape[0] == 0 or boxes_b.shape[0] == 0:
        return np.zeros((boxes_a.shape[0], boxes_b.shape[0]), np.float32)
    return native.bev_iou(boxes_a, boxes_b).astype(np.float32)


class DataBaseSampler:
    """GT-database paste augmentation (reference database_sampler.py)."""

    def __init__(self, root_path, sampler_cfg, class_names, logger=None):
        self.root_path = Path(root_path)
        self.sampler_cfg = sampler_cfg
        self.class_names = class_names
        self.logger = logger
        self.db_infos = {c: [] for c in class_names}
        for db_info_path in sampler_cfg.DB_INFO_PATH:
            with open(self.root_path / db_info_path, "rb") as f:
                infos = pickle.load(f)
            for c in class_names:
                self.db_infos[c].extend(infos.get(c, []))

        for func_name, val in sampler_cfg.PREPARE.items():
            self.db_infos = getattr(self, func_name)(self.db_infos, val)

        self.sample_groups = {}
        self.sample_class_num = {}
        self.limit_whole_scene = sampler_cfg.get("LIMIT_WHOLE_SCENE", False)
        for x in sampler_cfg.SAMPLE_GROUPS:
            class_name, sample_num = x.split(":")
            if class_name not in class_names:
                continue
            self.sample_class_num[class_name] = sample_num
            self.sample_groups[class_name] = {
                "sample_num": sample_num,
                "pointer": len(self.db_infos[class_name]),
                "indices": np.arange(len(self.db_infos[class_name])),
            }

    def filter_by_difficulty(self, db_infos, removed_difficulty):
        return {
            k: [i for i in v if i["difficulty"] not in removed_difficulty]
            for k, v in db_infos.items()
        }

    def filter_by_min_points(self, db_infos, min_gt_points_list):
        for name_num in min_gt_points_list:
            name, min_num = name_num.split(":")
            min_num = int(min_num)
            if min_num > 0 and name in db_infos:
                db_infos[name] = [i for i in db_infos[name] if i["num_points_in_gt"] >= min_num]
        return db_infos

    def sample_with_fixed_number(self, class_name, sample_group):
        sample_num = int(sample_group["sample_num"])
        pointer, indices = sample_group["pointer"], sample_group["indices"]
        if pointer >= len(self.db_infos[class_name]):
            indices = np.random.permutation(len(self.db_infos[class_name]))
            pointer = 0
        sampled = [self.db_infos[class_name][i] for i in indices[pointer: pointer + sample_num]]
        sample_group["pointer"] = pointer + sample_num
        sample_group["indices"] = indices
        return sampled

    @staticmethod
    def put_boxes_on_road_planes(gt_boxes, road_plane, calib):
        a, b, c, d = road_plane
        center_cam = calib.lidar_to_rect(gt_boxes[:, 0:3])
        height_cam = (-d - a * center_cam[:, 0] - c * center_cam[:, 2]) / b
        center_cam[:, 1] = height_cam
        lidar_height = calib.rect_to_lidar(center_cam)[:, 2]
        mv_height = gt_boxes[:, 2] - gt_boxes[:, 5] / 2 - lidar_height
        gt_boxes[:, 2] -= mv_height
        return gt_boxes, mv_height

    def __call__(self, data_dict):
        gt_boxes = data_dict["gt_boxes"]
        gt_names = data_dict["gt_names"].astype(str)
        existed = gt_boxes
        total_sampled = []
        for class_name, group in self.sample_groups.items():
            if self.limit_whole_scene:
                num_gt = int(np.sum(class_name == gt_names))
                group["sample_num"] = str(int(self.sample_class_num[class_name]) - num_gt)
            if int(group["sample_num"]) <= 0:
                continue
            sampled = self.sample_with_fixed_number(class_name, group)
            if len(sampled) == 0:
                continue
            boxes = np.stack([x["box3d_lidar"] for x in sampled]).astype(np.float32)
            iou1 = _bev_iou_cpu(boxes, existed)
            iou2 = _bev_iou_cpu(boxes, boxes)
            np.fill_diagonal(iou2, 0)
            iou1 = iou1 if iou1.shape[1] > 0 else iou2
            valid = ((iou1.max(axis=1) + iou2.max(axis=1)) == 0).nonzero()[0]
            total_sampled.extend([sampled[i] for i in valid])
            existed = np.concatenate([existed, boxes[valid]])

        sampled_boxes = existed[gt_boxes.shape[0]:]
        if len(total_sampled) > 0:
            data_dict = self._add_to_scene(data_dict, sampled_boxes, total_sampled)
        data_dict.pop("gt_boxes_mask", None)
        return data_dict

    def _add_to_scene(self, data_dict, sampled_boxes, sampled_infos):
        mask = data_dict.get("gt_boxes_mask", np.ones(len(data_dict["gt_boxes"]), bool))
        gt_boxes = data_dict["gt_boxes"][mask]
        gt_names = data_dict["gt_names"][mask]
        points = data_dict["points"]
        calib = data_dict.get("calib")  # may be popped by the road-plane branch

        mv_height = None
        if self.sampler_cfg.get("USE_ROAD_PLANE", False) and "road_plane" in data_dict:
            sampled_boxes, mv_height = self.put_boxes_on_road_planes(
                sampled_boxes, data_dict["road_plane"], data_dict["calib"]
            )
            data_dict.pop("calib", None)
            data_dict.pop("road_plane", None)

        obj_points_list = []
        for idx, info in enumerate(sampled_infos):
            obj_points = np.fromfile(
                str(self.root_path / info["path"]), dtype=np.float32
            ).reshape(-1, int(self.sampler_cfg.NUM_POINT_FEATURES)).copy()
            obj_points[:, :3] += info["box3d_lidar"][:3]
            if mv_height is not None:
                obj_points[:, 2] -= mv_height[idx]
            obj_points_list.append(obj_points)
        obj_points = np.concatenate(obj_points_list)
        sampled_names = np.array([x["name"] for x in sampled_infos])

        large = box_np.enlarge_box3d(
            sampled_boxes[:, 0:7], tuple(self.sampler_cfg.REMOVE_EXTRA_WIDTH)
        )
        # any-box membership only → the native first-hit index (early exit +
        # z prefilter) beats the (M, N) numpy mask ~20x on dense scans
        from ..utils import native

        idx = native.points_in_boxes_index(points[:, 0:3], large)
        points = points[idx < 0]
        data_dict["points"] = np.concatenate([obj_points, points])
        data_dict["gt_names"] = np.concatenate([gt_names, sampled_names])
        data_dict["gt_boxes"] = np.concatenate([gt_boxes, sampled_boxes])
        if data_dict.get("gt_boxes2d") is not None:
            # row-aligned with gt_boxes: the kept originals, then each sampled
            # box's projected corners' extent (clipped to the image), as in JAX
            b2d = data_dict["gt_boxes2d"][mask[: len(data_dict["gt_boxes2d"])]]
            if calib is not None:
                corners = box_np.boxes_to_corners_3d(sampled_boxes[:, :7]).reshape(-1, 3)
                img = calib.project_rect_to_image(calib.lidar_to_rect(corners)).reshape(-1, 8, 2)
                new2d = np.concatenate([img.min(axis=1), img.max(axis=1)], axis=1).astype(
                    np.float32)
                if data_dict.get("image_shape") is not None:
                    h, w = int(data_dict["image_shape"][0]), int(data_dict["image_shape"][1])
                    new2d[:, [0, 2]] = np.clip(new2d[:, [0, 2]], 0, w - 1)
                    new2d[:, [1, 3]] = np.clip(new2d[:, [1, 3]], 0, h - 1)
            else:
                new2d = np.zeros((len(sampled_boxes), 4), np.float32)
            data_dict["gt_boxes2d"] = np.concatenate([b2d, new2d]).astype(np.float32)
        return data_dict


def random_flip_along_x(gt_boxes, points):
    if np.random.choice([False, True]):
        gt_boxes[:, 1] = -gt_boxes[:, 1]
        gt_boxes[:, 6] = -gt_boxes[:, 6]
        points[:, 1] = -points[:, 1]
        if gt_boxes.shape[1] > 7:  # velocity columns [vx, vy]: y-flip negates vy
            gt_boxes[:, 8] = -gt_boxes[:, 8]
    return gt_boxes, points


def random_flip_along_y(gt_boxes, points):
    if np.random.choice([False, True]):
        gt_boxes[:, 0] = -gt_boxes[:, 0]
        gt_boxes[:, 6] = -(gt_boxes[:, 6] + np.pi)
        points[:, 0] = -points[:, 0]
        if gt_boxes.shape[1] > 7:  # x-flip negates vx
            gt_boxes[:, 7] = -gt_boxes[:, 7]
    return gt_boxes, points


def global_rotation(gt_boxes, points, rot_range):
    angle = np.random.uniform(rot_range[0], rot_range[1])
    points[:, :3] = box_np.rotate_points_along_z(
        points[np.newaxis, :, :3], np.array([angle])
    )[0]
    if len(gt_boxes) > 0:
        gt_boxes[:, 0:3] = box_np.rotate_points_along_z(
            gt_boxes[np.newaxis, :, 0:3], np.array([angle])
        )[0]
        gt_boxes[:, 6] += angle
        if gt_boxes.shape[1] > 7:  # rotate velocity vector with the scene
            vel = np.concatenate(
                [gt_boxes[:, 7:9], np.zeros((gt_boxes.shape[0], 1), gt_boxes.dtype)],
                axis=1,
            )
            gt_boxes[:, 7:9] = box_np.rotate_points_along_z(
                vel[np.newaxis], np.array([angle])
            )[0][:, :2]
    return gt_boxes, points


def random_image_flip_horizontal(image, depth_map, gt_boxes, calib, gt_boxes2d=None):
    """With probability 1/2 (one ``np.random.choice`` draw, as in JAX) flip
    the image and depth map left-right; the 3D boxes' centres mirror through
    the image plane (u → W − u at their depth) and their headings negate,
    the lidar points stay put (reference augmentor_utils.py:80-115), and the
    2D boxes mirror with the image (u1, u2 → W − u2, W − u1)."""
    if not np.random.choice([False, True], replace=False, p=[0.5, 0.5]):
        return image, depth_map, gt_boxes, gt_boxes2d
    image = np.ascontiguousarray(np.fliplr(image))
    if depth_map is not None:
        depth_map = np.ascontiguousarray(np.fliplr(depth_map))
    gt_boxes = gt_boxes.copy()
    if len(gt_boxes):
        rect = calib.lidar_to_rect(gt_boxes[:, :3])
        img_pts = calib.project_rect_to_image(rect)
        u = image.shape[1] - img_pts[:, 0]
        uvd = np.stack([u, img_pts[:, 1], rect[:, 2]], 1)
        gt_boxes[:, :3] = calib.rect_to_lidar(calib.project_image_to_rect(uvd))
        gt_boxes[:, 6] = -gt_boxes[:, 6]
    if gt_boxes2d is not None and len(gt_boxes2d):
        gt_boxes2d = gt_boxes2d.copy()
        w = image.shape[1]
        u1, u2 = gt_boxes2d[:, 0].copy(), gt_boxes2d[:, 2].copy()
        gt_boxes2d[:, 0] = w - u2
        gt_boxes2d[:, 2] = w - u1
    return image, depth_map, gt_boxes, gt_boxes2d


def global_scaling(gt_boxes, points, scale_range):
    if scale_range[1] - scale_range[0] < 1e-3:
        return gt_boxes, points
    scale = np.random.uniform(scale_range[0], scale_range[1])
    points[:, :3] *= scale
    gt_boxes[:, :6] *= scale
    return gt_boxes, points


class DataAugmentor:
    def __init__(self, root_path, augmentor_cfg, class_names, logger=None):
        self.root_path = root_path
        self.class_names = class_names
        self.queue = []
        cfg_list = (
            augmentor_cfg if isinstance(augmentor_cfg, list) else augmentor_cfg.AUG_CONFIG_LIST
        )
        disable = [] if isinstance(augmentor_cfg, list) else list(
            augmentor_cfg.get("DISABLE_AUG_LIST", [])
        )
        for cfg in cfg_list:
            if cfg.NAME in disable:
                continue
            if cfg.NAME == "gt_sampling":
                self.queue.append(DataBaseSampler(root_path, cfg, class_names, logger))
            else:
                self.queue.append((cfg.NAME, cfg))

    def __call__(self, data_dict):
        for aug in self.queue:
            if isinstance(aug, DataBaseSampler):
                data_dict = aug(data_dict)
                continue
            name, cfg = aug
            gt, pts = data_dict["gt_boxes"], data_dict["points"]
            if name == "random_world_flip":
                for axis in cfg.ALONG_AXIS_LIST:
                    fn = {"x": random_flip_along_x, "y": random_flip_along_y}[axis]
                    gt, pts = fn(gt, pts)
            elif name == "random_world_rotation":
                rot = cfg.WORLD_ROT_ANGLE
                if not isinstance(rot, (list, tuple)):
                    rot = [-rot, rot]
                gt, pts = global_rotation(gt, pts, rot)
            elif name == "random_world_scaling":
                gt, pts = global_scaling(gt, pts, cfg.WORLD_SCALE_RANGE)
            elif name == "random_image_flip":
                if list(cfg.ALONG_AXIS_LIST) != ["horizontal"]:
                    raise NotImplementedError(f"random_image_flip along {cfg.ALONG_AXIS_LIST}")
                img, dm, gt, b2d = random_image_flip_horizontal(
                    data_dict["images"], data_dict.get("depth_maps"), gt, data_dict["calib"],
                    data_dict.get("gt_boxes2d"))
                data_dict["images"] = img
                if dm is not None:
                    data_dict["depth_maps"] = dm
                if b2d is not None:
                    data_dict["gt_boxes2d"] = b2d
            else:
                raise NotImplementedError(name)
            data_dict["gt_boxes"], data_dict["points"] = gt, pts

        if len(data_dict.get("gt_boxes", [])) > 0:
            data_dict["gt_boxes"][:, 6] = box_np.limit_period(
                data_dict["gt_boxes"][:, 6], offset=0.5, period=2 * np.pi
            )
        data_dict.pop("calib", None)
        data_dict.pop("road_plane", None)
        if "gt_boxes_mask" in data_dict:
            m = data_dict.pop("gt_boxes_mask")
            data_dict["gt_boxes"] = data_dict["gt_boxes"][m]
            data_dict["gt_names"] = data_dict["gt_names"][m]
            if data_dict.get("gt_boxes2d") is not None:
                data_dict["gt_boxes2d"] = data_dict["gt_boxes2d"][m[: len(data_dict["gt_boxes2d"])]]
        return data_dict
