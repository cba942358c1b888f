"""A KITTI-format training set of full-density Lyft-like scans, written from
a seed: the traffic of a train mix.

The scans are ``lyft_scans.make_scan``'s, with the objects per scan drawn as
``lyft_scans.object_counts`` does, so every seed holds the same scene sizes.
The files are a frozen copy of what the port's ``tools/synth_kitti.py``
writes at ``full_density``: ``training/velodyne/<id>.bin``, the synthetic
camera's ``calib/<id>.txt`` (P2 focal 700 at (600, 200), lidar x forward),
``label_2/<id>.txt`` (``Dynamic`` boxes in camera coordinates with their
image boxes), the road plane under the scan in ``planes/<id>.txt``,
``image_2/<id>.png`` as a PNG header of 400 × 1200 (all a lidar dataset
reads of an image), and ``ImageSets/train.txt``. The program's own dataset
preparation then makes the infos and the gt database from these files.

Entry point of a train mix: ``write_dataset(root, seed, mix, cfg)``.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from bench_h100.traffic.lyft_scans import CU, CV, FOCAL, GROUND_Z, IMG_H, IMG_W, make_scan, \
    object_counts

# lidar (x forward, y left, z up) → camera (x right, y down, z forward)
V2C = np.array([[0.0, -1, 0, 0], [0, 0, -1, 0], [1.0, 0, 0, 0]])
P2 = np.array([[FOCAL, 0, CU, 0], [0, FOCAL, CV, 0], [0, 0, 1.0, 0]])


def _png_header(path: Path) -> None:
    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", IMG_W, IMG_H, 8, 2, 0, 0, 0)
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IEND", b""))


def label_lines(boxes: np.ndarray) -> list[str]:
    """KITTI label lines of lidar boxes (M, 7) x, y, z, l, w, h, yaw: the
    bottom centre in camera coordinates, yaw −r − π/2, and the image box of
    the eight corners clipped to the image."""
    lines = []
    for x, y, z, l, w, h, r in boxes.astype(np.float64):
        cam = np.array([-y, -(z - h / 2), x])
        ry = -r - np.pi / 2
        xs = np.array([l, l, -l, -l, l, l, -l, -l]) / 2
        zs = np.array([w, -w, -w, w, w, -w, -w, w]) / 2
        ys = np.array([0, 0, 0, 0, -h, -h, -h, -h])
        c, s = np.cos(ry), np.sin(ry)
        corners = np.stack([xs * c + zs * s, ys, -xs * s + zs * c], 1) + cam
        u = FOCAL * corners[:, 0] / corners[:, 2] + CU
        v = FOCAL * corners[:, 1] / corners[:, 2] + CV
        u1, u2 = np.clip([u.min(), u.max()], 0, IMG_W - 1)
        v1, v2 = np.clip([v.min(), v.max()], 0, IMG_H - 1)
        alpha = -np.arctan2(cam[0], cam[2]) + ry
        lines.append(f"Dynamic -1 -1 {alpha:.4f} {u1:.2f} {v1:.2f} {u2:.2f} {v2:.2f} "
                     f"{h:.4f} {w:.4f} {l:.4f} {cam[0]:.4f} {cam[1]:.4f} {cam[2]:.4f} {ry:.4f}")
    return lines


def write_dataset(root: Path, seed: int, mix: dict, cfg: dict) -> None:
    """``mix["scans"]`` training scans under ``root``, drawn from ``seed``."""
    root = Path(root)
    for sub in ("velodyne", "calib", "label_2", "image_2", "planes"):
        (root / "training" / sub).mkdir(parents=True, exist_ok=True)
    (root / "ImageSets").mkdir(exist_ok=True)
    rng = np.random.default_rng(seed)
    counts = object_counts(int(mix["scans"]), rng)
    calib = "".join(f"{key}: {' '.join(map(str, m.reshape(-1)))}\n" for key, m in (
        ("P2", P2), ("P3", P2), ("R0_rect", np.eye(3)), ("Tr_velo_to_cam", V2C)))
    # the road in rect coordinates, −y + d = 0 (y down): the ground at y = −GROUND_Z
    plane = "# Plane\nWidth 4\nHeight 1\n" + " ".join(
        f"{v:.6e}" for v in (0.0, -1.0, 0.0, -GROUND_Z)) + "\n"
    ids = []
    for i, n_objects in enumerate(counts):
        name = f"{i:06d}"
        scan, boxes = make_scan(rng, int(n_objects))
        scan.astype(np.float32).tofile(root / "training" / "velodyne" / f"{name}.bin")
        (root / "training" / "calib" / f"{name}.txt").write_text(calib)
        (root / "training" / "planes" / f"{name}.txt").write_text(plane)
        (root / "training" / "label_2" / f"{name}.txt").write_text(
            "\n".join(label_lines(boxes)) + "\n")
        _png_header(root / "training" / "image_2" / f"{name}.png")
        ids.append(name)
    (root / "ImageSets" / "train.txt").write_text("\n".join(ids) + "\n")
