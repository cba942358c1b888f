"""KITTI-format dataset: info building, gt-database creation, training
samples — port of ``modest_tpu/data/kitti_dataset.py`` (reference
pcdet/datasets/kitti/kitti_dataset.py + dataset.py).

Host-side numpy; every sample has a fixed shape after the sample_points
processor, so batches stack into dense (B, N, 4) tensors. Predictions become
KITTI annos of numpy arrays (``generate_prediction_dicts``), so a
``result.pkl`` of either package reads in the other. The camera models'
items (images, depth maps) are not ported.
"""
from __future__ import annotations

import copy
import pickle
import struct
from pathlib import Path

import numpy as np

from ..utils import box_np, kitti_io
from .augmentor import DataAugmentor
from .processor import DataProcessor, PointFeatureEncoder


def png_shape(path) -> np.ndarray:
    """(H, W) of a PNG from its IHDR header — no image library needed."""
    with open(path, "rb") as f:
        head = f.read(26)
    assert head[:8] == b"\x89PNG\r\n\x1a\n", f"not a png: {path}"
    w, h = struct.unpack(">II", head[16:24])
    return np.array([h, w], dtype=np.int32)


def drop_info_with_name(info: dict, name: str) -> dict:
    keep = [i for i, x in enumerate(info["name"]) if x != name]
    return {k: (v[keep] if isinstance(v, np.ndarray) else v) for k, v in info.items()}


class KittiDataset:
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None, logger=None):
        self.dataset_cfg = dataset_cfg
        self.class_names = list(class_names)
        self.training = training
        self.logger = logger
        self.root_path = Path(root_path if root_path is not None else dataset_cfg.DATA_PATH)
        self.mode = "train" if training else "test"
        self.split = dataset_cfg.DATA_SPLIT[self.mode]
        self.root_split_path = self.root_path / ("training" if self.split != "test" else "testing")
        self.point_cloud_range = np.asarray(dataset_cfg.POINT_CLOUD_RANGE, np.float32)
        self.constant_reflex = dataset_cfg.get("CONSTANT_REFLEX", False)
        self._merge_all_iters_to_one_epoch = False
        self.total_epochs = 1

        split_file = self.root_path / "ImageSets" / f"{self.split}.txt"
        self.sample_id_list = (
            [x.strip() for x in open(split_file).readlines()] if split_file.exists() else None
        )

        unported = set(dataset_cfg.get("GET_ITEM_LIST", ["points"])) - {"points"}
        if unported:
            raise NotImplementedError(f"modest_tpu_torch: dataset items {sorted(unported)} "
                                      f"are not ported")
        self.point_feature_encoder = PointFeatureEncoder(dataset_cfg.POINT_FEATURE_ENCODING)
        self.data_augmentor = (
            DataAugmentor(self.root_path, dataset_cfg.DATA_AUGMENTOR, self.class_names, logger)
            if training and dataset_cfg.get("DATA_AUGMENTOR") is not None
            else None
        )
        self.data_processor = DataProcessor(
            dataset_cfg.DATA_PROCESSOR, self.point_cloud_range, training
        )
        self.grid_size = self.data_processor.grid_size
        self.voxel_size = self.data_processor.voxel_size

        self.kitti_infos = []
        self.include_kitti_data(self.mode)

    # --- raw file access -----------------------------------------------
    def include_kitti_data(self, mode):
        for info_path in self.dataset_cfg.INFO_PATH[mode]:
            p = self.root_path / info_path
            if not p.exists():
                continue
            with open(p, "rb") as f:
                self.kitti_infos.extend(pickle.load(f))
        if self.logger:
            self.logger.info(f"Total samples for KITTI dataset: {len(self.kitti_infos)}")

    def set_split(self, split):
        self.split = split
        self.root_split_path = self.root_path / ("training" if split != "test" else "testing")
        split_file = self.root_path / "ImageSets" / f"{split}.txt"
        self.sample_id_list = (
            [x.strip() for x in open(split_file).readlines()] if split_file.exists() else None
        )
        self.kitti_infos = []

    def get_lidar(self, idx):
        from ..utils import native

        points = native.load_velo(self.root_split_path / "velodyne" / f"{idx}.bin")
        if self.constant_reflex:
            points[:, 3] = self.constant_reflex
        return points

    def get_image_shape(self, idx):
        return png_shape(self.root_split_path / "image_2" / f"{idx}.png")

    def get_label(self, idx):
        return kitti_io.read_label(self.root_split_path / "label_2" / f"{idx}.txt")

    def get_calib(self, idx):
        return kitti_io.Calibration(self.root_split_path / "calib" / f"{idx}.txt")

    def get_road_plane(self, idx):
        plane_file = self.root_split_path / "planes" / f"{idx}.txt"
        if not plane_file.exists():
            return None
        return kitti_io.load_plane(plane_file)

    # --- info building ---------------------------------------------------
    def get_infos(self, has_label=True, count_inside_pts=True, sample_id_list=None):
        sample_id_list = sample_id_list or self.sample_id_list
        infos = []
        for sample_idx in sample_id_list:
            info = {"point_cloud": {"num_features": 4, "lidar_idx": sample_idx}}
            info["image"] = {
                "image_idx": sample_idx,
                "image_shape": self.get_image_shape(sample_idx),
            }
            calib = self.get_calib(sample_idx)
            P2 = np.concatenate([calib.P2, np.array([[0.0, 0.0, 0.0, 1.0]])], axis=0)
            R0_4x4 = np.zeros((4, 4), dtype=calib.R0.dtype)
            R0_4x4[3, 3] = 1.0
            R0_4x4[:3, :3] = calib.R0
            V2C_4x4 = np.concatenate([calib.V2C, np.array([[0.0, 0.0, 0.0, 1.0]])], axis=0)
            info["calib"] = {"P2": P2, "R0_rect": R0_4x4, "Tr_velo_to_cam": V2C_4x4}

            if has_label:
                obj_list = self.get_label(sample_idx)
                annos = {
                    "name": np.array([o.cls_type for o in obj_list]),
                    "truncated": np.array([o.truncation for o in obj_list]),
                    "occluded": np.array([o.occlusion for o in obj_list]),
                    "alpha": np.array([o.alpha for o in obj_list]),
                    "bbox": (
                        np.stack([o.box2d for o in obj_list])
                        if obj_list
                        else np.zeros((0, 4))
                    ),
                    "dimensions": np.array([[o.l, o.h, o.w] for o in obj_list]).reshape(-1, 3),
                    "location": (
                        np.stack([o.loc for o in obj_list]) if obj_list else np.zeros((0, 3))
                    ),
                    "rotation_y": np.array([o.ry for o in obj_list]),
                    "score": np.array([o.score for o in obj_list]),
                    "difficulty": np.array([o.level for o in obj_list], np.int32),
                }
                num_objects = len([o for o in obj_list if o.cls_type != "DontCare"])
                num_gt = len(annos["name"])
                annos["index"] = np.array(
                    list(range(num_objects)) + [-1] * (num_gt - num_objects), np.int32
                )
                if obj_list:
                    loc = annos["location"][:num_objects]
                    dims = annos["dimensions"][:num_objects]
                    rots = annos["rotation_y"][:num_objects]
                    loc_lidar = calib.rect_to_lidar(loc)
                    l, h, w = dims[:, 0:1], dims[:, 1:2], dims[:, 2:3]
                    loc_lidar[:, 2] += h[:, 0] / 2
                    annos["gt_boxes_lidar"] = np.concatenate(
                        [loc_lidar, l, w, h, -(np.pi / 2 + rots[..., None])], axis=1
                    )
                else:
                    annos["gt_boxes_lidar"] = np.zeros((0, 7))
                info["annos"] = annos

                if count_inside_pts and obj_list:
                    points = self.get_lidar(sample_idx)
                    pts_rect = calib.lidar_to_rect(points[:, 0:3])
                    if self.dataset_cfg.FOV_POINTS_ONLY:
                        fov = kitti_io.get_fov_flag(pts_rect, info["image"]["image_shape"], calib)
                        pts = points[fov]
                    else:
                        pts = points
                    mask = box_np.points_in_boxes_mask(pts[:, 0:3], annos["gt_boxes_lidar"])
                    num_in = -np.ones(num_gt, np.int32)
                    num_in[:num_objects] = mask[:num_objects].sum(axis=1)
                    annos["num_points_in_gt"] = num_in
                elif count_inside_pts:
                    annos["num_points_in_gt"] = np.zeros(0, np.int32)
            infos.append(info)
        return infos

    def create_groundtruth_database(self, info_path, used_classes=None, split="train"):
        db_dir = self.root_path / ("gt_database" if split == "train" else f"gt_database_{split}")
        db_info_path = self.root_path / f"kitti_dbinfos_{split}.pkl"
        db_dir.mkdir(parents=True, exist_ok=True)
        all_db_infos = {}
        with open(info_path, "rb") as f:
            infos = pickle.load(f)
        for info in infos:
            sample_idx = info["point_cloud"]["lidar_idx"]
            points = self.get_lidar(sample_idx)
            annos = info["annos"]
            gt_boxes = annos["gt_boxes_lidar"]
            if gt_boxes.shape[0] == 0:
                continue
            in_box = box_np.points_in_boxes_mask(points[:, 0:3], gt_boxes)
            for i in range(gt_boxes.shape[0]):
                name = annos["name"][i]
                filename = f"{sample_idx}_{name}_{i}.bin"
                gt_points = points[in_box[i]].copy()
                gt_points[:, :3] -= gt_boxes[i, :3]
                gt_points.astype(np.float32).tofile(db_dir / filename)
                if used_classes is None or name in used_classes:
                    db_info = {
                        "name": name,
                        "path": str((db_dir / filename).relative_to(self.root_path)),
                        "image_idx": sample_idx,
                        "gt_idx": i,
                        "box3d_lidar": gt_boxes[i],
                        "num_points_in_gt": gt_points.shape[0],
                        "difficulty": annos["difficulty"][i],
                        "bbox": annos["bbox"][i],
                        "score": annos["score"][i],
                    }
                    all_db_infos.setdefault(name, []).append(db_info)
        with open(db_info_path, "wb") as f:
            pickle.dump(all_db_infos, f)
        return all_db_infos

    # --- sample generation ------------------------------------------------
    def __len__(self):
        if self._merge_all_iters_to_one_epoch:
            return len(self.kitti_infos) * self.total_epochs
        return len(self.kitti_infos)

    def merge_all_iters_to_one_epoch(self, merge=True, epochs=None):
        self._merge_all_iters_to_one_epoch = merge
        self.total_epochs = epochs

    def __getitem__(self, index):
        if self._merge_all_iters_to_one_epoch:
            index = index % len(self.kitti_infos)
        info = copy.deepcopy(self.kitti_infos[index])
        sample_idx = info["point_cloud"]["lidar_idx"]
        img_shape = info["image"]["image_shape"]
        calib = self.get_calib(sample_idx)
        input_dict = {"frame_id": sample_idx, "calib": calib}

        if "annos" in info:
            annos = drop_info_with_name(info["annos"], name="DontCare")
            if len(annos["name"]) > 0:
                gt_boxes_camera = np.concatenate(
                    [annos["location"], annos["dimensions"], annos["rotation_y"][..., None]],
                    axis=1,
                ).astype(np.float32)
                input_dict["gt_names"] = annos["name"]
                input_dict["gt_boxes"] = box_np.boxes3d_kitti_camera_to_lidar(
                    gt_boxes_camera, calib
                )
            else:
                input_dict["gt_names"] = annos["name"]
                input_dict["gt_boxes"] = np.zeros((0, 7), float)
            road_plane = self.get_road_plane(sample_idx)
            if road_plane is not None:
                input_dict["road_plane"] = road_plane

        points = self.get_lidar(sample_idx)
        if self.dataset_cfg.FOV_POINTS_ONLY:
            from ..utils import native

            rect_3x4 = np.hstack(
                [calib.R0 @ calib.V2C[:, :3], (calib.R0 @ calib.V2C[:, 3])[:, None]]
            )
            fov = native.fov_mask(points, rect_3x4, calib.P2, img_shape)
            points = points[fov]
        input_dict["points"] = points

        data_dict = self.prepare_data(input_dict)
        data_dict["image_shape"] = img_shape
        return data_dict

    def prepare_data(self, data_dict):
        """Augment → class-filter → encode → process (reference dataset.py:109-170)."""
        if self.training:
            assert "gt_boxes" in data_dict
            if self.data_augmentor is not None:
                mask = np.array([n in self.class_names for n in data_dict["gt_names"]], bool)
                data_dict = self.data_augmentor({**data_dict, "gt_boxes_mask": mask})

        if data_dict.get("gt_boxes") is not None:
            selected = [i for i, n in enumerate(data_dict["gt_names"]) if n in self.class_names]
            data_dict["gt_boxes"] = data_dict["gt_boxes"][selected]
            data_dict["gt_names"] = data_dict["gt_names"][selected]
            gt_classes = np.array(
                [self.class_names.index(n) + 1 for n in data_dict["gt_names"]], np.int32
            )
            data_dict["gt_boxes"] = np.concatenate(
                [data_dict["gt_boxes"], gt_classes.reshape(-1, 1).astype(np.float32)], axis=1
            )

        if data_dict.get("points") is not None:
            data_dict = self.point_feature_encoder(data_dict)
        data_dict = self.data_processor(data_dict)

        if self.training and len(data_dict["gt_boxes"]) == 0:
            return self.__getitem__(np.random.randint(len(self)))

        data_dict.pop("gt_names", None)
        if self.training:  # eval keeps calib for prediction→camera conversion
            data_dict.pop("calib", None)
        data_dict.pop("road_plane", None)
        return data_dict

    # --- predictions & evaluation -----------------------------------------
    @staticmethod
    def generate_prediction_dicts(batch_dict, pred_dicts, class_names, output_path=None):
        """Predictions → KITTI annos (reference kitti_dataset.py:316-393).

        pred_dicts entries: pred_boxes (K, 7), pred_scores (K,), pred_labels
        (K,) numpy, already trimmed to the valid rows."""
        annos = []
        for index, box_dict in enumerate(pred_dicts):
            frame_id = batch_dict["frame_id"][index]
            calib = batch_dict["calib"][index]
            image_shape = batch_dict["image_shape"][index]
            pred_boxes = np.asarray(box_dict["pred_boxes"]).reshape(-1, 7)
            pred_scores = np.asarray(box_dict["pred_scores"]).reshape(-1)
            pred_labels = np.asarray(box_dict["pred_labels"]).reshape(-1).astype(int)
            n = pred_boxes.shape[0]
            single = {
                "name": np.zeros(n, dtype="<U32"),
                "truncated": np.zeros(n),
                "occluded": np.zeros(n),
                "alpha": np.zeros(n),
                "bbox": np.zeros((n, 4)),
                "dimensions": np.zeros((n, 3)),
                "location": np.zeros((n, 3)),
                "rotation_y": np.zeros(n),
                "score": np.zeros(n),
                "boxes_lidar": pred_boxes,
                "frame_id": frame_id,
            }
            if n > 0:
                cam = box_np.boxes3d_lidar_to_kitti_camera(pred_boxes, calib)
                img = box_np.boxes3d_kitti_camera_to_imageboxes(cam, calib, image_shape)
                single["name"] = np.array(class_names)[pred_labels - 1]
                single["alpha"] = -np.arctan2(-pred_boxes[:, 1], pred_boxes[:, 0]) + cam[:, 6]
                single["bbox"] = img
                single["dimensions"] = cam[:, 3:6]
                single["location"] = cam[:, 0:3]
                single["rotation_y"] = cam[:, 6]
                single["score"] = pred_scores
            annos.append(single)
            if output_path is not None:
                with open(Path(output_path) / f"{frame_id}.txt", "w") as f:
                    for k in range(n):
                        bbox, loc, dims = (single["bbox"][k], single["location"][k],
                                           single["dimensions"][k])
                        print(f"{single['name'][k]} -1 -1 {single['alpha'][k]:.4f} "
                              f"{bbox[0]:.4f} {bbox[1]:.4f} {bbox[2]:.4f} {bbox[3]:.4f} "
                              f"{dims[1]:.4f} {dims[2]:.4f} {dims[0]:.4f} "
                              f"{loc[0]:.4f} {loc[1]:.4f} {loc[2]:.4f} "
                              f"{single['rotation_y'][k]:.4f} {single['score'][k]:.4f}", file=f)
        return annos

    def evaluation(self, det_annos, class_names, range_eval=True, ranges=(0, 30, 50, 80)):
        """(result text, AP dict) of ``det_annos`` against this split's gt
        annos; (None, {}) when the infos hold no labels."""
        if not self.kitti_infos or "annos" not in self.kitti_infos[0]:
            return None, {}
        from ..eval import kitti_eval

        eval_det = copy.deepcopy(det_annos)
        eval_gt = [copy.deepcopy(info["annos"]) for info in self.kitti_infos]
        if range_eval:
            return kitti_eval.get_range_eval_result(eval_gt, eval_det, class_names, ranges=ranges)
        return kitti_eval.get_official_eval_result(eval_gt, eval_det, class_names)


def create_kitti_infos(dataset_cfg, class_names, data_path, save_path, if_val=True):
    """Build kitti_infos_{train,val}.pkl + the train gt database."""
    save_path = Path(save_path)
    dataset = KittiDataset(dataset_cfg, class_names, root_path=data_path, training=False)

    dataset.set_split("train")
    train_infos = dataset.get_infos(has_label=True, count_inside_pts=True)
    train_file = save_path / "kitti_infos_train.pkl"
    with open(train_file, "wb") as f:
        pickle.dump(train_infos, f)
    print(f"Kitti info train file is saved to {train_file}")

    if if_val:
        dataset.set_split("val")
        val_infos = dataset.get_infos(has_label=True, count_inside_pts=True)
        with open(save_path / "kitti_infos_val.pkl", "wb") as f:
            pickle.dump(val_infos, f)
        print(f"Kitti info val file is saved to {save_path / 'kitti_infos_val.pkl'}")

    dataset.set_split("train")
    dataset.create_groundtruth_database(train_file, split="train")
    print("Data preparation done")


if __name__ == "__main__":
    # python -m modest_tpu_torch.data.kitti_dataset create_kitti_infos <dataset_cfg.yaml> \
    #     [data_path] [if_val]   (the reference's `python -m pcdet.datasets.kitti.kitti_dataset`)
    import sys

    if len(sys.argv) > 1 and sys.argv[1] == "create_kitti_infos":
        from ..utils.config import cfg_from_yaml_file

        dataset_cfg = cfg_from_yaml_file(sys.argv[2])
        data_path = sys.argv[3] if len(sys.argv) > 3 else dataset_cfg.DATA_PATH
        if_val = sys.argv[4] == "True" if len(sys.argv) > 4 else True
        create_kitti_infos(
            dataset_cfg=dataset_cfg,
            class_names=["Dynamic"],
            data_path=data_path,
            save_path=data_path,
            if_val=if_val,
        )
