"""Dataset preparation in modest_tpu_torch against the JAX package: analogs of
tests/test_preprocessing.py, tests/test_nu_tables.py and the tracking test
of tests/test_seed_labels.py, each running the JAX function and the port's
on the same seeded inputs. The converters (on test_nu_tables' one-scene
dataset, images and all) and the split, traversal-gathering and plane CLIs
(on a three-drive dataset of ``tools/nu_scenes.py``) must write byte-equal
files in both packages; the port's chain then feeds its PP CLI."""
from __future__ import annotations

import filecmp
import pickle
import types
from pathlib import Path

import numpy as np
import pytest

from modest_tpu.pipeline import tracking as j_tracking
from modest_tpu.preprocessing import converters as j_conv
from modest_tpu.preprocessing import gather_historical_traversals as j_gather
from modest_tpu.preprocessing import nu_tables as j_nu
from modest_tpu.preprocessing import ransac_planes as j_ransac
from modest_tpu.preprocessing import split_traintest as j_split
from modest_tpu.utils import pose as j_pose
from modest_tpu_torch.pipeline import tracking
from modest_tpu_torch.preprocessing import (converters, gather_historical_traversals,
                                            nu_tables, ransac_planes, split_traintest)
from modest_tpu_torch.tools import nu_scenes
from modest_tpu_torch.utils import pose
from tests.test_nu_tables import build_dataset, mat_to_quat
from tests.test_preprocessing import straight_line_poses
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _same_tree(a: Path, b: Path):
    """Every file under ``a`` and ``b`` byte-equal, and the same names."""
    fa = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    fb = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert fa == fb and fa
    for rel in fa:
        assert filecmp.cmp(a / rel, b / rel, shallow=False), rel


# --- tests/test_preprocessing.py ----------------------------------------------------


def test_geo_split():
    track_list = [[0, 1], [2, 3], [4, 5]]
    poses = [straight_line_poses(2, y) for y in (100.0, 2000.0, 100.0)]
    got = split_traintest.geo_split(track_list, poses, cutoff=1700.0, axis=1)
    assert got == j_split.geo_split(track_list, poses, cutoff=1700.0, axis=1)
    assert got == ([[0, 1], [4, 5]], [[2, 3]])


def test_traversal_index_parallel_roads():
    n = 60
    track_list = [list(range(0, n)), list(range(n, 2 * n)), list(range(2 * n, 3 * n))]
    poses = [straight_line_poses(n, y0=dy) for dy in (0.0, 0.5, 1.0)]
    for only_forward in (True, False):
        args = (track_list, poses, 3.0, np.arange(2, 21, 2), only_forward)
        got = split_traintest.build_traversal_index(*args)
        assert got == j_split.build_traversal_index(*args) and len(got) > n // 2


def test_traversal_index_requires_two():
    n = 30
    track_list = [list(range(0, n)), list(range(n, 2 * n))]
    poses = [straight_line_poses(n, 0.0), straight_line_poses(n, 0.5)]
    args = (track_list, poses, 3.0, np.arange(2, 11, 2), True)
    assert split_traintest.build_traversal_index(*args) == {}
    assert j_split.build_traversal_index(*args) == {}


def test_plane_for_frame(rng):
    n = 3000
    pts = np.stack([rng.uniform(-15, 15, n), rng.normal(1.7, 0.01, n), rng.uniform(0, 60, n)], 1)
    got = ransac_planes.plane_for_frame(pts, min_h=1.5, max_h=2.0)
    np.testing.assert_array_equal(got, j_ransac.plane_for_frame(pts, min_h=1.5, max_h=2.0))
    np.testing.assert_allclose(abs(got[3]), 1.7, atol=0.05)
    np.testing.assert_array_equal(ransac_planes.plane_for_frame(pts[:2]),
                                  j_ransac.plane_for_frame(pts[:2]))


def test_quat_to_matrix_known_values():
    rng = np.random.RandomState(1)
    for q in [[1, 0, 0, 0], [np.cos(np.pi / 4), 0, 0, np.sin(np.pi / 4)], [0, 0, 0, 0],
              *rng.randn(5, 4)]:
        np.testing.assert_array_equal(converters.quat_to_matrix(q), j_conv.quat_to_matrix(q))
    np.testing.assert_allclose(converters.quat_to_matrix([1, 0, 0, 0]), np.eye(3), atol=1e-12)


def test_transform_matrix_inverse():
    q = list(np.asarray([0.9, 0.1, 0.2, 0.05]) / np.linalg.norm([0.9, 0.1, 0.2, 0.05]))
    t = [1.0, -2.0, 3.0]
    for inverse in (False, True):
        np.testing.assert_array_equal(converters.transform_matrix(t, q, inverse),
                                      j_conv.transform_matrix(t, q, inverse))
    np.testing.assert_array_equal(converters.form_trans_mat(t, q), j_conv.form_trans_mat(t, q))


def test_oxts_roundtrip():
    rng = np.random.RandomState(2)
    for yaw in (0.3, -2.9, np.pi / 2):
        q = [np.cos(yaw), *(rng.randn(2) * 0.05), np.sin(yaw)]
        q = list(np.asarray(q) / np.linalg.norm(q))
        line = converters.oxts_line_from_pose([10.0, 20.0, 1.0], q)
        assert line == j_conv.oxts_line_from_pose([10.0, 20.0, 1.0], q)
        vals = [float(x) for x in line.split()]
        np.testing.assert_array_equal(pose.pose_from_oxts_line(vals),
                                      j_pose.pose_from_oxts_line(vals))
        np.testing.assert_allclose(pose.pose_from_oxts_line(vals)[:3, :3],
                                   converters.quat_to_matrix(q), atol=1e-9)


def test_box_nu_to_kitti_camera():
    velo_to_cam_kitti = np.array([[0, -1, 0, 0], [0, 0, -1, 0.5], [1, 0, 0, 0], [0, 0, 0, 1]],
                                 np.float64)
    rot = converters.quat_to_matrix([np.cos(np.pi / 2), 0, 0, np.sin(np.pi / 2)])
    for yaw in (np.pi, np.pi / 2):
        args = ([-10.0, 0.0, -0.5], (1.8, 4.2, 1.5), rot, velo_to_cam_kitti, yaw)
        got = converters.box_nu_lidar_to_kitti_camera(*args)
        np.testing.assert_array_equal(got, j_conv.box_nu_lidar_to_kitti_camera(*args))
    np.testing.assert_allclose(converters.box_nu_lidar_to_kitti_camera(
        *args[:4])[[2, 6]], [10.0, -np.pi / 2], atol=1e-6)


def test_project_box_and_occlusion():
    P = np.array([[700.0, 0, 600, 0], [0, 700.0, 200, 0], [0, 0, 1, 0]])
    for box7 in ([0.0, 1.0, 20.0, 4.0, 1.5, 1.8, 0.0], [8.0, 1.0, 6.0, 4.0, 1.5, 1.8, 0.7],
                 [0.0, 1.0, -5.0, 4.0, 1.5, 1.8, 0.0]):
        assert converters.project_box_to_2d(np.array(box7), P, 400, 1200) == \
            j_conv.project_box_to_2d(np.array(box7), P, 400, 1200)
    objs = [{"bbox_2d": (100, 100, 200, 200), "depth": 10.0},
            {"bbox_2d": (150, 150, 250, 250), "depth": 20.0}]
    got = converters.estimate_occlusions([dict(o) for o in objs], 400, 1200)
    want = j_conv.estimate_occlusions([dict(o) for o in objs], 400, 1200)
    assert got == want and [o["occluded"] for o in got] == [want[0]["occluded"], 0]


def test_kitti_label_line_parses():
    from modest_tpu_torch.utils.kitti_io import Object3d

    args = ("Dynamic", [1.0, 2.0, 30.0, 4.2, 1.5, 1.8, 0.3], (10, 20, 110, 120), 0.0, 1, 0.5)
    line = converters.kitti_label_line(*args)
    assert line == j_conv.kitti_label_line(*args)
    obj = Object3d(line)
    assert obj.cls_type == "Dynamic" and obj.occlusion == 1


def test_gen_gt_mask_points_in_camera_box():
    from modest_tpu.cli.gen_gt_mask import points_in_camera_box as j_points_in_camera_box
    from modest_tpu_torch.cli.gen_gt_mask import points_in_camera_box

    rng = np.random.RandomState(3)
    obj = types.SimpleNamespace(t=np.array([0.0, 1.0, 20.0]), l=4.0, w=2.0, h=1.5, ry=0.4)
    pts = rng.uniform([-4, -1, 16], [4, 2, 24], (500, 3))
    got = points_in_camera_box(pts, obj)
    np.testing.assert_array_equal(got, j_points_in_camera_box(pts, obj))
    assert 0 < got.sum() < len(pts)


def test_kitti_res_roundtrip_to_nuscenes():
    rng = np.random.RandomState(3)
    v2c = np.array([[0, -1, 0, 0.1], [0, 0, -1, 0.4], [1, 0, 0, -0.2], [0, 0, 0, 1]], np.float64)
    for _ in range(10):
        box7 = np.concatenate([rng.uniform(-30, 30, 3), rng.uniform(1, 4, 3),
                               rng.uniform(-np.pi, np.pi, 1)])
        got = converters.kitti_res_to_nuscenes_box(box7, v2c, kitti_to_nu_yaw=np.pi / 2)
        want = j_conv.kitti_res_to_nuscenes_box(box7, v2c, kitti_to_nu_yaw=np.pi / 2)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


def test_find_closest_integer():
    for query in (105, 99, 110, 2 ** 40):
        ref = np.array([100, 104, 110, 2 ** 40 - 3])
        assert converters.find_closest_integer(query, ref) == j_conv.find_closest_integer(query,
                                                                                           ref)


# --- tests/test_nu_tables.py --------------------------------------------------------


def test_mat_quat_roundtrip():
    """Quaternions through matrices, and the Euler angles the oxts files
    carry (``utils/pose.py::matrix_to_euler_xyz``), gimbal lock included."""
    rng = np.random.RandomState(3)
    for _ in range(10):
        q = rng.randn(4)
        R = converters.quat_to_matrix(q / np.linalg.norm(q))
        np.testing.assert_allclose(converters.quat_to_matrix(mat_to_quat(R)), R, atol=1e-10)
        np.testing.assert_array_equal(pose.matrix_to_euler_xyz(R), j_pose.matrix_to_euler_xyz(R))
        np.testing.assert_allclose(pose.euler_xyz_to_matrix(pose.matrix_to_euler_xyz(R)), R,
                                   atol=1e-9)
    lock = pose.euler_xyz_to_matrix([0.3, np.pi / 2, 0.0])
    np.testing.assert_array_equal(pose.matrix_to_euler_xyz(lock), j_pose.matrix_to_euler_xyz(lock))


def test_reverse_index(tmp_path):
    build_dataset(tmp_path)
    nt = nu_tables.NuTables(tmp_path, tmp_path / "v1.0-mini")
    jt = j_nu.NuTables(tmp_path, tmp_path / "v1.0-mini")
    for name in nu_tables.TABLE_NAMES:
        assert getattr(nt, name) == getattr(jt, name), name
    assert nt.get("sample", "samp1")["data"]["LIDAR_TOP"] == "sd_lid2"
    np.testing.assert_array_equal(nu_tables.load_lidar(tmp_path / "lidar" / "sweep0.bin"),
                                  j_nu.load_lidar(tmp_path / "lidar" / "sweep0.bin"))


def test_get_sample_data_box_transform(tmp_path):
    build_dataset(tmp_path)
    nt = nu_tables.NuTables(tmp_path, tmp_path / "v1.0-mini")
    jt = j_nu.NuTables(tmp_path, tmp_path / "v1.0-mini")
    for sd, anns in (("sd_lid2", ["ann1"]), ("sd_cam1", None)):
        path, boxes, intr = nt.get_sample_data(sd, selected_anntokens=anns)
        jpath, jboxes, jintr = jt.get_sample_data(sd, selected_anntokens=anns)
        assert path == jpath and len(boxes) == len(jboxes) == 1
        np.testing.assert_array_equal(boxes[0].center, jboxes[0].center)
        np.testing.assert_array_equal(boxes[0].rotation_matrix, jboxes[0].rotation_matrix)
        assert boxes[0].orientation_yaw == jboxes[0].orientation_yaw
        assert (intr is None) == (jintr is None)


def test_lyft_converter_e2e(tmp_path):
    """The SDK-free Lyft export of both packages, file for file."""
    data = tmp_path / "lyft"
    build_dataset(data, category="car")
    conv = converters.LyftToKittiConverter(tmp_path / "port", data, data / "v1.0-mini",
                                           use_sdk=False)
    assert isinstance(conv.lyft_ds, nu_tables.NuTables)
    conv.convert()
    j_conv.LyftToKittiConverter(tmp_path / "jax", data, data / "v1.0-mini",
                                use_sdk=False).convert()
    _same_tree(tmp_path / "port", tmp_path / "jax")
    assert len(list((tmp_path / "port" / "training" / "image_2").glob("*.png"))) == 3


def test_nusc_converter_e2e(tmp_path):
    data = tmp_path / "nusc"
    build_dataset(data, category="vehicle.car")
    convs = [converters.NuscToKittiConverter(tmp_path / "port", data, version="v1.0-mini",
                                             use_sdk=False),
             j_conv.NuscToKittiConverter(tmp_path / "jax", data, version="v1.0-mini",
                                         use_sdk=False)]
    assert convs[0].samples_annotated() == convs[1].samples_annotated()
    assert convs[0].samples_full_rate() == convs[1].samples_full_rate()
    for conv in convs:
        for i, (lt, ct, anns) in enumerate(conv.samples_annotated()[0]):
            conv.process_pair(i, lt, ct, ann_tokens=anns)
        full, _ = conv.samples_full_rate()
        conv.convert_labels = False
        for i, (lt, ct) in enumerate(full[:2]):
            conv.process_pair(10 + i, lt, ct)
    _same_tree(tmp_path / "port", tmp_path / "jax")


def test_label_box_projects_into_image(tmp_path):
    data = tmp_path / "lyft"
    build_dataset(data, category="car")
    converters.LyftToKittiConverter(tmp_path / "kitti", data, data / "v1.0-mini",
                                    use_sdk=False).convert()
    f = (tmp_path / "kitti" / "training" / "label_2" / "000000.txt").read_text().split()
    x1, y1, x2, y2 = map(float, f[4:8])
    assert 0 <= x1 < x2 <= 1200 and 0 <= y1 < y2 <= 400


# --- tests/test_seed_labels.py::test_tracking_association --------------------------


def test_tracking_association():
    frames, poses = {}, {}
    for f in range(6):
        a = [5.0 + f, 0.0, 0.0, 4, 2, 1.5, 0.0]
        b = [20.0, 10.0 + 0.5 * f, 0.0, 4, 2, 1.5, 1.0]
        frames[f] = np.array([a, b]) if 2 <= f != 4 else np.array([a])
        poses[f] = pose.rotz4(0.01 * f)
    for kwargs in ({}, {"poses": poses}):
        tracks = tracking.build_tracks(frames, iou_threshold=0.1, **kwargs)
        want = j_tracking.build_tracks(frames, iou_threshold=0.1, **kwargs)
        assert [(t.track_id, t.frames) for t in tracks] == [(t.track_id, t.frames) for t in want]
        for t, w in zip(tracks, want):
            np.testing.assert_array_equal(np.stack(t.boxes), np.stack(w.boxes))
            for f in (t.frames[0], t.frames[-1], (t.frames[0] + t.frames[-1]) / 2):
                np.testing.assert_array_equal(tracking.interpolate_track(t, f),
                                              j_tracking.interpolate_track(w, f))
    assert sorted(len(t) for t in tracks) == [3, 6]


# --- the CLIs on a multi-drive export -----------------------------------------------


@pytest.fixture(scope="module")
def drives(tmp_path_factory):
    """Three drives of tools/nu_scenes.py exported by the port's Lyft
    converter, with the track list the split reads."""
    root = tmp_path_factory.mktemp("drives")
    table_dir, track_list = nu_scenes.write_traversal_tables(
        root / "lyft", traversals=3, frames=20, spacing=4.0, n_ground=600, n_wall=150,
        n_cars=2, car_points=40, seed=0)
    store = root / "kitti"
    nu_scenes.write_kitti_images(store, sum(len(t) for t in track_list))
    converters.LyftToKittiConverter(store, root / "lyft", table_dir, use_sdk=False).convert()
    with open(root / "tracks.pkl", "wb") as f:
        pickle.dump(track_list, f)
    return types.SimpleNamespace(root=root, store=store, tracks=root / "tracks.pkl",
                                 track_list=track_list)


def _split(main, drives, out):
    out.mkdir(parents=True, exist_ok=True)
    main(["--data_root", str(drives.store), "--track_list_file", str(drives.tracks),
          "--save_root", str(out)])


def test_split_traintest_cli_writes_the_jax_files(drives, tmp_path):
    _split(split_traintest.main, drives, tmp_path / "port")
    _split(j_split.main, drives, tmp_path / "jax")
    _same_tree(tmp_path / "port", tmp_path / "jax")
    with open(tmp_path / "port" / "fw70_2m_valid_train_idx_info.pkl", "rb") as f:
        valid = pickle.load(f)
    assert len(valid) >= 3 and all(len(v[2]) == 2 for v in valid.values())


def test_gather_historical_traversals_cli_writes_the_jax_files(drives, tmp_path):
    meta = tmp_path / "meta"
    _split(split_traintest.main, drives, meta)
    for name, main in (("port", gather_historical_traversals.main), ("jax", j_gather.main)):
        main(["--data_root", str(drives.store / "training"),
              "--track_list", str(meta / "fw70_2m_train_track_list.pkl"),
              "--idx_info", str(meta / "fw70_2m_valid_train_idx_info.pkl"),
              "--save_dir", str(tmp_path / name / "clouds"),
              "--trans_mat_dir", str(tmp_path / name / "trans"), "--total_part", "2"])
    _same_tree(tmp_path / "port", tmp_path / "jax")
    clouds = sorted((tmp_path / "port" / "clouds").glob("*.pkl"))
    with open(clouds[0], "rb") as f:
        combined = pickle.load(f)
    assert len(combined) == 2 and all(len(c) > 0 for c in combined.values())


def test_ransac_planes_cli_writes_the_jax_files(drives, tmp_path):
    training = drives.store / "training"
    for name, main in (("port", ransac_planes.main), ("jax", j_ransac.main)):
        main(["--calib_dir", str(training / "calib"), "--lidar_dir", str(training / "velodyne"),
              "--planes_dir", str(tmp_path / name)])
    _same_tree(tmp_path / "port", tmp_path / "jax")
    from modest_tpu_torch.utils.kitti_io import load_plane

    plane = load_plane(tmp_path / "port" / "000000.txt")
    np.testing.assert_allclose(abs(plane[3]), nu_scenes.CAM_T[2], atol=0.05)  # camera height


def test_prepared_drives_feed_the_pp_cli(drives, tmp_path):
    """The port's chain (export, split, planes) is a dataset the PP CLI
    scores: one origin on the CPU, finite in [0, 1], one score a point."""
    from modest_tpu_torch.cli import pre_compute_pp_score
    from modest_tpu_torch.utils.kitti_io import load_velo_scan

    _split(split_traintest.main, drives, tmp_path / "meta_data" / "lyft")
    idx = [int(x) for x in (tmp_path / "meta_data/lyft/fw70_2m_train_idx.txt").read_text().split()]
    data_root = drives.store / "training"
    pre_compute_pp_score.main([f"work_dir={tmp_path}", f"data_root={data_root}", "device=cpu",
                               f"total_part={len(idx)}", "part=0"])
    pp = np.load(tmp_path / "intermediate_results/lyft_pp_score_fw70_2m_r0.3"
                 / f"{idx[0]:06d}.npy")
    n = load_velo_scan(data_root / "velodyne" / f"{idx[0]:06d}.bin").shape[0]
    assert pp.shape == (n,) and np.isfinite(pp).all() and 0 <= pp.min() <= pp.max() <= 1
