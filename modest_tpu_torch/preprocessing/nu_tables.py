"""SDK-free reader for nuScenes-schema datasets (nuScenes, Lyft L5) — the
port's own copy of ``modest_tpu/preprocessing/nu_tables.py`` (numpy only).

Both devkits (`nuscenes-devkit`, `lyft_dataset_sdk`) are thin wrappers over
the same on-disk contract: a directory of JSON tables (`scene.json`,
`sample.json`, `sample_data.json`, `sample_annotation.json`, `ego_pose.json`,
`calibrated_sensor.json`, `sensor.json`, `instance.json`, `category.json`)
plus raw sensor files referenced by relative `filename`. This module
implements the slice of the devkit surface the MODEST converters use
(reference data_preprocessing/lyft/sdk_gen_kitti_database.py and
data_preprocessing/nuscenes/nusc2kitti_boston.py drive the official SDKs;
the SDKs are pure-python table readers, so re-implementing the reader makes
the P1/P2 pipelines runnable end-to-end with no SDK install):

  * ``NuTables(dataroot, table_dir)`` — loads + indexes the tables and
    builds the devkit's reverse index (``sample["data"][channel]``,
    ``sample["anns"]``, denormalized ``category_name`` /
    ``sensor_modality`` / ``channel``), matching
    nuscenes-devkit ``NuScenes.__make_reverse_index__``.
  * ``.get(table, token)`` / ``.sample`` / ``.scene`` attributes.
  * ``.get_sample_data(sd_token, selected_anntokens=...)`` — returns
    (file path, boxes in the sensor frame, camera intrinsic), with the
    global→ego→sensor box transform chain of devkit ``get_sample_data``.
  * ``.get_box(ann_token)`` — a global-frame ``Box``.
  * ``load_lidar(path, ndim=5)`` — the LidarPointCloud.from_file contract
    (float32 x, y, z, intensity, [ring]).

Quaternion conventions follow the devkit (w, x, y, z), via
``converters.quat_to_matrix``.
"""
from __future__ import annotations

import json
import os.path as osp
from pathlib import Path

import numpy as np

TABLE_NAMES = [
    "category", "attribute", "visibility", "instance", "sensor",
    "calibrated_sensor", "ego_pose", "log", "scene", "sample",
    "sample_data", "sample_annotation", "map",
]


class Box:
    """Minimal devkit Box: center/wlh + rotation, mutated by transforms."""

    def __init__(self, center, size_wlh, rotation_matrix, name="", token=""):
        self.center = np.asarray(center, np.float64).copy()
        self.wlh = np.asarray(size_wlh, np.float64).copy()
        self.rotation_matrix = np.asarray(rotation_matrix, np.float64).copy()
        self.name = name
        self.token = token

    def translate(self, x):
        self.center = self.center + np.asarray(x, np.float64)

    def rotate(self, rot_matrix):
        rot_matrix = np.asarray(rot_matrix, np.float64)
        self.center = rot_matrix @ self.center
        self.rotation_matrix = rot_matrix @ self.rotation_matrix

    @property
    def orientation_yaw(self) -> float:
        return float(np.arctan2(self.rotation_matrix[1, 0],
                                self.rotation_matrix[0, 0]))


def load_lidar(path, ndim=5) -> np.ndarray:
    """(N, ndim) float32 scan — LidarPointCloud.from_file file contract.

    nuScenes and Lyft both store 5 float32s per point (x, y, z,
    intensity, ring); KITTI stores 4. A short final record is truncated
    rather than erroring (matches devkit reshape behavior).
    """
    raw = np.fromfile(str(path), dtype=np.float32)
    n = raw.size // ndim
    return raw[: n * ndim].reshape(n, ndim)


class NuTables:
    """Loads the JSON tables of one dataset version and mimics the devkit.

    Args:
      dataroot: directory the ``filename`` fields are relative to.
      table_dir: directory holding the ``*.json`` tables. For nuScenes
        this is ``{dataroot}/{version}`` (e.g. ``v1.0-trainval``); for
        Lyft it is the ``train_data``/``data`` folder. Defaults to
        ``dataroot`` itself.
    """

    def __init__(self, dataroot, table_dir=None):
        self.dataroot = str(dataroot)
        self.data_path = self.dataroot  # LyftDataset attribute name
        self.table_dir = str(table_dir) if table_dir is not None else self.dataroot
        self._tables = {}
        self._index = {}
        for name in TABLE_NAMES:
            p = Path(self.table_dir) / f"{name}.json"
            rows = json.loads(p.read_text()) if p.exists() else []
            self._tables[name] = rows
            self._index[name] = {r["token"]: r for r in rows}
        self._make_reverse_index()

    # --- devkit-compatible accessors -------------------------------------
    def __getattr__(self, name):
        # table lists as attributes: nusc.sample, nusc.scene, ...
        tables = self.__dict__.get("_tables")
        if tables is not None and name in tables:
            return tables[name]
        raise AttributeError(name)

    def get(self, table_name: str, token: str) -> dict:
        return self._index[table_name][token]

    def _make_reverse_index(self):
        # denormalize category_name onto annotations (devkit does this)
        for ann in self._tables["sample_annotation"]:
            inst = self._index["instance"].get(ann.get("instance_token", ""))
            if inst is not None:
                cat = self._index["category"].get(inst.get("category_token", ""))
                if cat is not None:
                    ann.setdefault("category_name", cat["name"])
        # denormalize sensor channel/modality onto sample_data
        for sd in self._tables["sample_data"]:
            cs = self._index["calibrated_sensor"].get(
                sd.get("calibrated_sensor_token", ""))
            if cs is not None:
                sensor = self._index["sensor"].get(cs.get("sensor_token", ""))
                if sensor is not None:
                    sd.setdefault("sensor_modality", sensor["modality"])
                    sd.setdefault("channel", sensor["channel"])
        # sample["data"][channel] and sample["anns"]
        for sample in self._tables["sample"]:
            sample.setdefault("data", {})
            sample.setdefault("anns", [])
        for sd in self._tables["sample_data"]:
            if not sd.get("is_key_frame"):
                continue
            sample = self._index["sample"].get(sd.get("sample_token", ""))
            if sample is not None and "channel" in sd:
                sample["data"][sd["channel"]] = sd["token"]
        for ann in self._tables["sample_annotation"]:
            sample = self._index["sample"].get(ann.get("sample_token", ""))
            if sample is not None:
                sample["anns"].append(ann["token"])

    # --- geometry --------------------------------------------------------
    def get_box(self, ann_token: str) -> Box:
        from .converters import quat_to_matrix

        ann = self.get("sample_annotation", ann_token)
        return Box(ann["translation"], ann["size"],
                   quat_to_matrix(ann["rotation"]),
                   name=ann.get("category_name", ""), token=ann_token)

    def get_sample_data(self, sd_token: str, selected_anntokens=None):
        """(file path, boxes in sensor frame, camera intrinsic or None).

        Matches devkit ``get_sample_data``: each global-frame annotation box
        is moved into the ego frame (inverse ego pose), then into the sensor
        frame (inverse calibrated_sensor extrinsic).
        """
        from .converters import quat_to_matrix

        sd = self.get("sample_data", sd_token)
        cs = self.get("calibrated_sensor", sd["calibrated_sensor_token"])
        pose = self.get("ego_pose", sd["ego_pose_token"])
        intrinsic = (np.array(cs["camera_intrinsic"], np.float64)
                     if cs.get("camera_intrinsic") else None)

        if selected_anntokens is not None:
            ann_tokens = selected_anntokens
        else:
            sample = self.get("sample", sd["sample_token"])
            ann_tokens = sample.get("anns", [])

        boxes = []
        ego_rot_inv = quat_to_matrix(pose["rotation"]).T
        cs_rot_inv = quat_to_matrix(cs["rotation"]).T
        for tok in ann_tokens:
            box = self.get_box(tok)
            box.translate(-np.asarray(pose["translation"], np.float64))
            box.rotate(ego_rot_inv)
            box.translate(-np.asarray(cs["translation"], np.float64))
            box.rotate(cs_rot_inv)
            boxes.append(box)
        return osp.join(self.dataroot, sd["filename"]), boxes, intrinsic
