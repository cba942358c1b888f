"""Synthetic KITTI-format training set (Lyft-like geometry), without an
image library.

The port's copy of ``tests/synth_kitti.py::make_dataset``: the same
velodyne, label, calib and plane files from the same seed. Images are PNG
headers only (signature, IHDR, IEND), which is all a lidar model's dataset
reads of them, or with ``pixels`` real 8-bit RGB PNGs (``utils/png.py``)
for the camera model: uniform noise with each labelled object's 2D box
painted in its class's colour, from a generator of its own seeded from
``seed``, so every other file is the same either way. ``full_density`` gives scans of ~72k–90k points with 8–20
``Dynamic`` objects each, the size of a Lyft scan, with road planes on
which gt sampling can paste objects; ``kitti_classes`` makes the objects
KITTI's Car, Pedestrian and Cyclist.
"""
from __future__ import annotations

import argparse
import os
import struct

import numpy as np

from ..utils import box_np, kitti_io
from ..utils.png import SIGNATURE, chunk, write_png

P2 = np.array([[700.0, 0, 600, 0], [0, 700.0, 200, 0], [0, 0, 1.0, 0]])
V2C = np.array([[0.0, -1, 0, 0], [0, 0, -1, 0], [1.0, 0, 0, 0]])
R0 = np.eye(3)
IMG_SHAPE = (400, 1200)  # H, W
# points per scan and objects: 60k ground + 8-20 objects of 1500 points
FULL_DENSITY = {"n_ground": 60000, "n_obj": 1500, "n_cars": (8, 21), "x_range": (10, 70),
                "y_range": (-6, 6)}
# kitti_classes: KITTI's mean sizes (l, w, h), each object's share of n_obj points,
# and object centres in KITTI's range [0, -40, -3, 70.4, 40, 1] and camera view
KITTI_SIZES = {"Car": (3.9, 1.6, 1.56), "Pedestrian": (0.8, 0.6, 1.73),
               "Cyclist": (1.76, 0.6, 1.73)}
KITTI_POINT_SHARE = {"Car": 1.0, "Pedestrian": 0.25, "Cyclist": 0.4}
KITTI_XY_RANGE = ((10, 60), (-8, 8))
# pixels: each class's box colour, and the pixel generator's seed offset
BOX_COLOURS = {"Dynamic": (220, 40, 40), "Car": (220, 40, 40), "Pedestrian": (40, 200, 60),
               "Cyclist": (50, 80, 230)}
PIXEL_SEED_OFFSET = 7919


def make_calib_obj():
    return kitti_io.Calibration({"P2": P2, "P3": P2, "R0_rect": R0, "Tr_velo_to_cam": V2C})


def write_png_header(path, h: int, w: int):
    """A PNG of (h, w) 8-bit RGB with no pixel data: signature, IHDR, IEND."""
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IEND", b""))


def write_image(path, img_boxes, names, rng):
    """An IMG_SHAPE RGB PNG of uniform noise with each 2D box [u1 v1 u2 v2]
    filled with its class's colour."""
    h, w = IMG_SHAPE
    pix = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    for name, box in zip(names, img_boxes):
        u1, v1, u2, v2 = (int(round(float(c))) for c in box)
        pix[max(v1, 0):min(v2, h), max(u1, 0):min(u2, w)] = BOX_COLOURS.get(name, (255, 255, 0))
    write_png(path, pix)


def _write_calib(path):
    with open(path, "w") as f:
        f.write("P2: " + " ".join(map(str, P2.reshape(-1))) + "\n")
        f.write("P3: " + " ".join(map(str, P2.reshape(-1))) + "\n")
        f.write("R0_rect: " + " ".join(map(str, R0.reshape(-1))) + "\n")
        f.write("Tr_velo_to_cam: " + " ".join(map(str, V2C.reshape(-1))) + "\n")


def make_dataset(root, n_train=4, n_val=2, seed=0, ground_z=-1.8, n_ground=4000, n_obj=300,
                 n_cars=(1, 3), x_range=(8, 45), y_range=(-8, 8), full_density=False,
                 kitti_classes=False, pixels=False):
    """Creates root/training/{velodyne,calib,label_2,image_2,planes} and
    ImageSets. Each frame: a ground plane and ``n_cars`` (low, high
    exclusive) 'Dynamic' cars of ``n_obj`` points ahead of the camera (lidar
    +x), labels in camera coordinates. ``full_density`` takes
    ``FULL_DENSITY``'s sizes and the road plane the ground lies on.
    ``kitti_classes`` makes each object a Car, Pedestrian or Cyclist of
    ``KITTI_SIZES`` (±10 %) with its ``KITTI_POINT_SHARE`` of ``n_obj``
    points, centred in ``KITTI_XY_RANGE``; left off, the files are the same
    byte for byte. ``pixels`` writes real images (the module docstring).
    Returns the lidar boxes by frame."""
    if full_density:
        n_ground, n_obj, n_cars, x_range, y_range = (
            FULL_DENSITY[k] for k in ("n_ground", "n_obj", "n_cars", "x_range", "y_range"))
    if kitti_classes:
        x_range, y_range = KITTI_XY_RANGE
    # the road plane in rect coordinates, -y + d = 0 (y points down): the
    # ground lies at y = -ground_z, so d = -ground_z. tests/synth_kitti.py
    # writes d = ground_z, a road above the camera, which lifts gt-sampled
    # boxes out of the point-cloud range; the default keeps its files
    plane_d = -ground_z if full_density else ground_z
    rng = np.random.RandomState(seed)
    pixel_rng = np.random.RandomState(seed + PIXEL_SEED_OFFSET)
    root = str(root)
    for sub in ["velodyne", "calib", "label_2", "image_2", "planes"]:
        os.makedirs(os.path.join(root, "training", sub), exist_ok=True)
    os.makedirs(os.path.join(root, "ImageSets"), exist_ok=True)
    calib = make_calib_obj()

    def make_frame(gid):
        cars = rng.randint(*n_cars)
        boxes = []
        pts = [np.stack([rng.uniform(2, 80, n_ground), rng.uniform(-30, 30, n_ground),
                         np.full(n_ground, ground_z) + rng.randn(n_ground) * 0.02], 1)]
        names = []
        for _ in range(cars):
            if kitti_classes:
                cls = list(KITTI_SIZES)[rng.randint(len(KITTI_SIZES))]
                l, w, h = np.asarray(KITTI_SIZES[cls]) * rng.uniform(0.9, 1.1, 3)
                n_pts = int(n_obj * KITTI_POINT_SHARE[cls])
            else:
                cls, n_pts = "Dynamic", n_obj
                l, w, h = rng.uniform(3.5, 4.5), rng.uniform(1.6, 2.0), rng.uniform(1.4, 1.7)
            names.append(cls)
            cx = rng.uniform(*x_range)
            cy = rng.uniform(*y_range)
            ry = rng.uniform(-np.pi, np.pi)
            cz = ground_z + h / 2
            box = np.array([cx, cy, cz, l, w, h, ry])
            local = rng.uniform(-0.5, 0.5, (n_pts, 3)) * [l, w, h]
            c, s = np.cos(ry), np.sin(ry)
            rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
            pts.append(local @ rot.T + box[:3])
            boxes.append(box)
        cloud = np.concatenate(pts).astype(np.float32)
        scan = np.concatenate([cloud, rng.rand(len(cloud), 1).astype(np.float32)], 1)
        name = f"{gid:06d}"
        kitti_io.save_velo_scan(os.path.join(root, "training", "velodyne", f"{name}.bin"), scan)
        _write_calib(os.path.join(root, "training", "calib", f"{name}.txt"))
        kitti_io.save_plane(os.path.join(root, "training", "planes", f"{name}.txt"),
                            np.array([0.0, -1.0, 0.0, plane_d]))
        lines = []
        boxes = np.array(boxes).reshape(-1, 7)
        cam = box_np.boxes3d_lidar_to_kitti_camera(boxes.copy(), calib)
        img_boxes = box_np.boxes3d_kitti_camera_to_imageboxes(cam.copy(), calib, IMG_SHAPE)
        image = os.path.join(root, "training", "image_2", f"{name}.png")
        if pixels:
            write_image(image, img_boxes, names, pixel_rng)
        else:
            write_png_header(image, IMG_SHAPE[0], IMG_SHAPE[1])
        for cls, b, ib in zip(names, cam, img_boxes):
            x, y, z, l, h, w, ry = b
            alpha = -np.arctan2(x, z) + ry
            lines.append(
                f"{cls} -1 -1 {alpha:.4f} {ib[0]:.2f} {ib[1]:.2f} {ib[2]:.2f} {ib[3]:.2f} "
                f"{h:.4f} {w:.4f} {l:.4f} {x:.4f} {y:.4f} {z:.4f} {ry:.4f}")
        with open(os.path.join(root, "training", "label_2", f"{name}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        return boxes

    gt = {}
    train_ids, val_ids = [], []
    for gid in range(n_train + n_val):
        gt[gid] = make_frame(gid)
        (train_ids if gid < n_train else val_ids).append(f"{gid:06d}")
    with open(os.path.join(root, "ImageSets", "train.txt"), "w") as f:
        f.write("\n".join(train_ids) + "\n")
    with open(os.path.join(root, "ImageSets", "val.txt"), "w") as f:
        f.write("\n".join(val_ids) + "\n")
    return gt


def main(argv=None):
    parser = argparse.ArgumentParser(description="write a synthetic KITTI-format dataset")
    parser.add_argument("root")
    parser.add_argument("--n_train", type=int, default=4)
    parser.add_argument("--n_val", type=int, default=2)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--full_density", action="store_true")
    parser.add_argument("--kitti_classes", action="store_true")
    parser.add_argument("--pixels", action="store_true", help="real images (noise and boxes)")
    args = parser.parse_args(argv)
    boxes = make_dataset(args.root, n_train=args.n_train, n_val=args.n_val, seed=args.seed,
                         full_density=args.full_density, kitti_classes=args.kitti_classes,
                         pixels=args.pixels)
    print(f"{len(boxes)} frames, {sum(len(b) for b in boxes.values())} objects in {args.root}")


if __name__ == "__main__":
    main()
