"""Native nuScenes dataset reader (multi-sweep, velocity-aware, CBGS-ready) —
port of ``modest_tpu/data/nuscenes_dataset.py``.

Reference: pcdet/datasets/nuscenes/nuscenes_dataset.py (374 LoC) +
nuscenes_utils.py. Everything that only needs the on-disk artifacts —
info pkls, .pcd.bin files, transform matrices baked into the infos — is
SDK-free; building infos from a raw nuScenes tree and the official NDS
evaluation need the `nuscenes` devkit and are gated on its import.

Info schema (same as the reference's *_infos_*.pkl):
  lidar_path, token, sweeps[{lidar_path, transform_matrix, time_lag}],
  gt_boxes (N, 9) [x y z dx dy dz heading vx vy] in lidar frame,
  gt_names (N,), num_lidar_pts (N,).
"""
from __future__ import annotations

import copy
import pickle
from pathlib import Path

import numpy as np

from ..utils.config import Config
from .augmentor import DataAugmentor
from .processor import DataProcessor, PointFeatureEncoder


class NuScenesDataset:
    """Infos-pkl driven loader (reference nuscenes_dataset.py:13-151)."""

    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None):
        self.dataset_cfg = Config(dataset_cfg)
        self.class_names = list(class_names)
        self.training = training
        root = Path(root_path if root_path is not None else self.dataset_cfg.DATA_PATH)
        version = self.dataset_cfg.get("VERSION", None)
        self.root_path = root / version if version else root
        self.logger = logger
        self.mode = "train" if training else "test"
        self._merge_all_iters_to_one_epoch = False
        self.total_epochs = 1

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
        self.include_nuscenes_data(self.mode)
        if self.training and self.dataset_cfg.get("BALANCED_RESAMPLING", False):
            self.infos = self.balanced_infos_resampling(self.infos)

    # --- infos -------------------------------------------------------------

    def include_nuscenes_data(self, mode):
        infos = []
        for info_path in self.dataset_cfg.INFO_PATH[mode]:
            p = self.root_path / info_path
            if not p.exists():
                continue
            with open(p, "rb") as f:
                infos.extend(pickle.load(f))
        self.infos.extend(infos)
        if self.logger:
            self.logger.info(f"Total samples for NuScenes dataset: {len(infos)}")

    def balanced_infos_resampling(self, infos):
        """Class-balanced resampling (CBGS, arXiv:1908.09492; reference
        nuscenes_dataset.py:39-75): duplicate frames so every class
        contributes ~1/num_classes of the class-occurrence mass."""
        if not self.class_names:
            return infos
        cls_infos = {name: [] for name in self.class_names}
        for info in infos:
            for name in set(info["gt_names"]):
                if name in cls_infos:
                    cls_infos[name].append(info)
        duplicated = sum(len(v) for v in cls_infos.values())
        if duplicated == 0:
            return infos
        frac = 1.0 / len(self.class_names)
        sampled = []
        for cur in cls_infos.values():
            if not cur:
                continue
            ratio = frac / (len(cur) / duplicated)
            sampled += np.random.choice(cur, int(len(cur) * ratio)).tolist()
        if self.logger:
            self.logger.info(f"Total samples after balanced resampling: {len(sampled)}")
        return sampled

    # --- points ------------------------------------------------------------

    @staticmethod
    def remove_ego_points(points, center_radius=1.0):
        mask = ~((np.abs(points[:, 0]) < center_radius)
                 & (np.abs(points[:, 1]) < center_radius))
        return points[mask]

    def get_sweep(self, sweep_info):
        """One aggregated sweep → (points (N, 4), time_lag (N, 1)); the
        transform matrix baked into the info maps sweep → keyframe lidar
        (reference nuscenes_dataset.py:77-92)."""
        lidar_path = self.root_path / sweep_info["lidar_path"]
        pts = np.fromfile(str(lidar_path), dtype=np.float32).reshape(-1, 5)[:, :4]
        pts = self.remove_ego_points(pts).T
        tm = sweep_info["transform_matrix"]
        if tm is not None:
            n = pts.shape[1]
            pts[:3, :] = tm.dot(np.vstack((pts[:3, :], np.ones(n))))[:3, :]
        times = sweep_info["time_lag"] * np.ones((1, pts.shape[1]))
        return pts.T, times.T

    def get_lidar_with_sweeps(self, index, max_sweeps=1):
        info = self.infos[index]
        lidar_path = self.root_path / info["lidar_path"]
        points = np.fromfile(str(lidar_path), dtype=np.float32).reshape(-1, 5)[:, :4]
        sweep_points = [points]
        sweep_times = [np.zeros((points.shape[0], 1))]
        n_avail = len(info["sweeps"])
        if n_avail > 0 and max_sweeps > 1:
            for k in np.random.choice(n_avail, max_sweeps - 1,
                                      replace=n_avail < max_sweeps - 1):
                pts, times = self.get_sweep(info["sweeps"][k])
                sweep_points.append(pts)
                sweep_times.append(times)
        points = np.concatenate(sweep_points, axis=0)
        times = np.concatenate(sweep_times, axis=0).astype(points.dtype)
        return np.concatenate((points, times), axis=1)

    # --- torch-free Dataset protocol ---------------------------------------

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
        points = self.get_lidar_with_sweeps(
            index, max_sweeps=int(self.dataset_cfg.get("MAX_SWEEPS", 1))
        )
        input_dict = {
            "points": points,
            "frame_id": Path(info["lidar_path"]).stem,
            "metadata": {"token": info.get("token")},
        }
        if "gt_boxes" in info:
            min_pts = self.dataset_cfg.get("FILTER_MIN_POINTS_IN_GT", False)
            if min_pts:
                mask = info["num_lidar_pts"] > int(min_pts) - 1
                input_dict["gt_names"] = info["gt_names"][mask]
                input_dict["gt_boxes"] = info["gt_boxes"][mask]
            else:
                input_dict["gt_names"] = info["gt_names"]
                input_dict["gt_boxes"] = info["gt_boxes"]
        data_dict = self.prepare_data(input_dict)
        if self.dataset_cfg.get("SET_NAN_VELOCITY_TO_ZEROS", False) \
                and "gt_boxes" in data_dict:
            gt = data_dict["gt_boxes"]
            gt[np.isnan(gt)] = 0
            data_dict["gt_boxes"] = gt
        if not self.dataset_cfg.get("PRED_VELOCITY", False) and "gt_boxes" in data_dict:
            # columns: [x y z dx dy dz heading vx vy class] → drop velocity
            data_dict["gt_boxes"] = data_dict["gt_boxes"][:, [0, 1, 2, 3, 4, 5, 6, -1]]
        return data_dict

    def prepare_data(self, data_dict):
        """Augment → class-filter → encode → process (same flow as
        KittiDataset.prepare_data; lidar frame, no calib/FOV)."""
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
                [data_dict["gt_boxes"].astype(np.float32),
                 gt_classes.reshape(-1, 1).astype(np.float32)], axis=1,
            )
        data_dict = self.point_feature_encoder(data_dict)
        data_dict = self.data_processor(data_dict)
        if self.training and data_dict.get("gt_boxes") is not None \
                and len(data_dict["gt_boxes"]) == 0:
            return self.__getitem__(np.random.randint(len(self)))
        data_dict.pop("gt_names", None)
        return data_dict

    # --- predictions & evaluation ------------------------------------------

    @staticmethod
    def generate_prediction_dicts(batch_dict, pred_dicts, class_names,
                                  output_path=None):
        """Device outputs → lidar-frame annos (reference :153-197)."""
        annos = []
        for index, box_dict in enumerate(pred_dicts):
            scores = np.asarray(box_dict["pred_scores"]).reshape(-1)
            boxes = np.asarray(box_dict["pred_boxes"]).reshape(-1, box_dict["pred_boxes"].shape[-1])
            labels = np.asarray(box_dict["pred_labels"]).reshape(-1).astype(np.int64)
            anno = {
                "name": (np.array(class_names)[labels - 1]
                         if len(scores) else np.zeros(0)),
                "score": scores,
                "boxes_lidar": boxes,
                "pred_labels": labels,
                "frame_id": batch_dict["frame_id"][index],
                "metadata": batch_dict.get("metadata", [None] * (index + 1))[index],
            }
            annos.append(anno)
        return annos

    def evaluation(self, det_annos, class_names, output_path=None, **kwargs):
        """Official NDS/mAP evaluation when the nuscenes devkit is present
        (reference :199-263); otherwise a lidar-frame BEV/3D AP fallback so
        a host without the SDK still gets a number."""
        try:
            import nuscenes  # noqa: F401
        except ImportError:
            return self._fallback_evaluation(det_annos, class_names)
        from nuscenes.nuscenes import NuScenes

        nusc = NuScenes(version=self.dataset_cfg.VERSION,
                        dataroot=str(self.root_path), verbose=True)
        return self._nusc_official_eval(nusc, det_annos, output_path)

    def _fallback_evaluation(self, det_annos, class_names):
        """Official-protocol mAP/TP/NDS via the SDK-free evaluator
        (eval/nuscenes_eval.py), plus the kitti-style BEV/3D AP table."""
        from ..eval.kitti_eval import ap_from_lidar_annos
        from ..eval.nuscenes_eval import nuscenes_eval

        gt_annos = [
            {"name": info["gt_names"], "boxes_lidar": info["gt_boxes"],
             **({"num_lidar_pts": info["num_lidar_pts"]}
                if "num_lidar_pts" in info else {})}
            for info in self.infos
        ]
        nds_str, nds_dict = nuscenes_eval(
            gt_annos, det_annos, class_names,
            pred_velocity=bool(self.dataset_cfg.get("PRED_VELOCITY", False)),
        )
        gt7 = [{"name": g["name"], "boxes_lidar": g["boxes_lidar"][:, :7]}
               for g in gt_annos]
        ap_str, ap_dict = ap_from_lidar_annos(gt7, det_annos, class_names)
        ap_dict.update(nds_dict)
        return (ap_str or "") + nds_str, ap_dict

    def _nusc_official_eval(self, nusc, det_annos, output_path):
        import json

        from nuscenes.eval.detection.config import config_factory
        from nuscenes.eval.detection.evaluate import NuScenesEval

        from .nuscenes_writer import transform_det_annos_to_nusc_annos

        nusc_annos = transform_det_annos_to_nusc_annos(det_annos, nusc)
        nusc_annos["meta"] = {
            "use_camera": False, "use_lidar": True, "use_radar": False,
            "use_map": False, "use_external": False,
        }
        output_path = Path(output_path or ".")
        output_path.mkdir(exist_ok=True, parents=True)
        res_path = output_path / "results_nusc.json"
        with open(res_path, "w") as f:
            json.dump(nusc_annos, f)
        eval_set_map = {"v1.0-mini": "mini_val", "v1.0-trainval": "val",
                        "v1.0-test": "test"}
        nusc_eval = NuScenesEval(
            nusc, config=config_factory("detection_cvpr_2019"),
            result_path=str(res_path),
            eval_set=eval_set_map[self.dataset_cfg.VERSION],
            output_dir=str(output_path), verbose=True,
        )
        nusc_eval.main(plot_examples=0, render_curves=False)
        with open(output_path / "metrics_summary.json") as f:
            metrics = json.load(f)
        result = "\n"
        for name in self.class_names:
            aps = metrics["label_aps"].get(name, {})
            result += f"{name}: " + " ".join(
                f"AP@{d}={v:.4f}" for d, v in sorted(aps.items())) + "\n"
        result += f"mAP: {metrics['mean_ap']:.4f}  NDS: {metrics['nd_score']:.4f}\n"
        return result, {"mAP": metrics["mean_ap"], "NDS": metrics["nd_score"]}

    # --- gt database -------------------------------------------------------

    def create_groundtruth_database(self, used_classes=None, max_sweeps=10):
        """Crop per-GT point clouds into gt_database_<N>sweeps_withvelo/
        (reference :265-318), with numpy points-in-rotated-box."""
        from ..utils.box_np import points_in_boxes_mask

        db_path = self.root_path / f"gt_database_{max_sweeps}sweeps_withvelo"
        db_info_path = self.root_path / f"nuscenes_dbinfos_{max_sweeps}sweeps_withvelo.pkl"
        db_path.mkdir(parents=True, exist_ok=True)
        all_db_infos = {}
        for idx in range(len(self.infos)):
            info = self.infos[idx]
            points = self.get_lidar_with_sweeps(idx, max_sweeps=max_sweeps)
            gt_boxes = np.asarray(info["gt_boxes"], np.float32)
            gt_names = np.asarray(info["gt_names"])
            if len(gt_boxes) == 0:
                continue
            inside = points_in_boxes_mask(points, gt_boxes[:, :7])  # (M, N)
            for i in range(len(gt_boxes)):
                name = str(gt_names[i])
                if used_classes is not None and name not in used_classes:
                    continue
                gt_points = points[inside[i]]
                if gt_points.shape[0] == 0:
                    continue
                gt_points = gt_points.copy()
                gt_points[:, :3] -= gt_boxes[i, :3]
                filename = f"{idx}_{name}_{i}.bin"
                gt_points.astype(np.float32).tofile(db_path / filename)
                db_info = {
                    "name": name,
                    "path": str((db_path / filename).relative_to(self.root_path)),
                    "image_idx": idx, "gt_idx": i,
                    "box3d_lidar": gt_boxes[i],
                    "num_points_in_gt": gt_points.shape[0],
                }
                all_db_infos.setdefault(name, []).append(db_info)
        with open(db_info_path, "wb") as f:
            pickle.dump(all_db_infos, f)
        return db_info_path


def create_nuscenes_infos(version, data_path, save_path, max_sweeps=10):
    """Build *_infos_*.pkl from a raw nuScenes tree. Requires the `nuscenes`
    devkit (not in this image — reference nuscenes_utils.fill_trainval_infos);
    the on-disk schema it writes is documented at the top of this module so
    infos built elsewhere load without the SDK."""
    try:
        from nuscenes.nuscenes import NuScenes
        from nuscenes.utils import splits
    except ImportError as e:  # pragma: no cover - SDK not in image
        raise ImportError(
            "create_nuscenes_infos requires the nuscenes devkit "
            "(pip install nuscenes-devkit) — info pkls built on any host "
            "with the SDK are loadable here without it"
        ) from e

    from .nuscenes_writer import fill_trainval_infos  # pragma: no cover

    data_path, save_path = Path(data_path), Path(save_path)
    nusc = NuScenes(version=version, dataroot=str(data_path / version), verbose=True)
    if version == "v1.0-trainval":
        train_scenes, val_scenes = splits.train, splits.val
    elif version == "v1.0-test":
        train_scenes, val_scenes = splits.test, []
    elif version == "v1.0-mini":
        train_scenes, val_scenes = splits.mini_train, splits.mini_val
    else:
        raise ValueError(version)
    train_infos, val_infos = fill_trainval_infos(
        nusc, train_scenes, val_scenes, test=(version == "v1.0-test"),
        max_sweeps=max_sweeps,
    )
    out = save_path / version
    out.mkdir(parents=True, exist_ok=True)
    suffix = f"_{max_sweeps}sweeps_withvelo.pkl"
    if version == "v1.0-test":
        with open(out / f"nuscenes_infos{suffix}", "wb") as f:
            pickle.dump(train_infos, f)
    else:
        with open(out / f"nuscenes_infos_train{suffix}", "wb") as f:
            pickle.dump(train_infos, f)
        with open(out / f"nuscenes_infos_val{suffix}", "wb") as f:
            pickle.dump(val_infos, f)


if __name__ == "__main__":
    # python -m modest_tpu_torch.data.nuscenes_dataset create_nuscenes_infos \
    #     --version v1.0-trainval --data_path data/nuscenes [--max_sweeps 10]
    # (reference: python -m pcdet.datasets.nuscenes.nuscenes_dataset)
    import argparse
    import sys

    if len(sys.argv) > 1 and sys.argv[1] == "create_nuscenes_infos":
        parser = argparse.ArgumentParser()
        parser.add_argument("func")
        parser.add_argument("--version", default="v1.0-trainval")
        parser.add_argument("--data_path", required=True)
        parser.add_argument("--save_path", default=None)
        parser.add_argument("--max_sweeps", type=int, default=10)
        parser.add_argument("--with_gt_database", action="store_true")
        args = parser.parse_args()
        create_nuscenes_infos(
            version=args.version, data_path=args.data_path,
            save_path=args.save_path or args.data_path,
            max_sweeps=args.max_sweeps,
        )
