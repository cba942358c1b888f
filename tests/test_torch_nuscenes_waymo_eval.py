"""The port's SDK-free nuScenes and Waymo metrics (``eval/nuscenes_eval.py``,
``eval/waymo_eval.py``) against the JAX package's, on every case of
``tests/test_nuscenes_eval.py`` and ``tests/test_waymo_eval.py``.

Each JAX test runs with the evaluator names it imported wrapped: a call
runs the JAX function and the port's on deep copies of the same inputs,
holds their results equal within 1e-9, and hands the JAX result back to
the test's own assertions. Then both metrics on a random scene of many
frames, classes, velocities, difficulty levels and ties in score.
"""
import copy
import inspect

import numpy as np
import pytest

import test_nuscenes_eval as j_nusc_cases
import test_waymo_eval as j_waymo_cases
from modest_tpu.eval import nuscenes_eval as j_nusc
from modest_tpu.eval import waymo_eval as j_waymo
from modest_tpu_torch.eval import nuscenes_eval as t_nusc
from modest_tpu_torch.eval import waymo_eval as t_waymo

TOL = 1e-9


def assert_same(got, want, path="result"):
    """Equal structure; strings equal, numbers within TOL (NaN where NaN)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (tuple, list)) and not isinstance(want, str):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray) and want.dtype.kind in "fiub":
        np.testing.assert_allclose(np.asarray(got, np.float64), want.astype(np.float64),
                                   rtol=0, atol=TOL, err_msg=path)
    elif isinstance(want, (float, int, np.floating, np.integer)) and not isinstance(want, bool):
        if np.isnan(want):
            assert np.isnan(got), path
        else:
            assert abs(float(got) - float(want)) <= TOL, (path, got, want)
    else:
        assert got == want, path


def _both(name, j_fn, t_fn):
    def call(*args, **kwargs):
        want = j_fn(*copy.deepcopy(args), **copy.deepcopy(kwargs))
        got = t_fn(*copy.deepcopy(args), **copy.deepcopy(kwargs))
        assert_same(got, want, name)
        return want
    return call


def _cases(module):
    return [name for name, fn in inspect.getmembers(module, inspect.isfunction)
            if name.startswith("test_") and fn.__module__ == module.__name__]


@pytest.mark.parametrize("case", _cases(j_nusc_cases))
def test_nuscenes_eval_cases_match_jax(case, monkeypatch):
    for name in ("accumulate", "calc_ap", "calc_tp", "nuscenes_eval"):
        monkeypatch.setattr(j_nusc_cases, name,
                            _both(name, getattr(j_nusc, name), getattr(t_nusc, name)))
    getattr(j_nusc_cases, case)()


@pytest.mark.parametrize("case", _cases(j_waymo_cases))
def test_waymo_eval_cases_match_jax(case, monkeypatch):
    for name in ("waymo_detection_metrics", "heading_accuracy"):
        monkeypatch.setattr(j_waymo_cases, name,
                            _both(name, getattr(j_waymo, name), getattr(t_waymo, name)))
    getattr(j_waymo_cases, case)()


def _scene(rng, n_frames, classes, velocity):
    """Per-frame gt and detections: detections near most gts (jittered
    centres, sizes and headings), false positives, scores with ties."""
    gts, dets = [], []
    for _ in range(n_frames):
        m = rng.randint(0, 9)
        names = np.asarray([classes[i] for i in rng.randint(len(classes), size=m)])
        boxes = np.zeros((m, 9 if velocity else 7))
        boxes[:, :2] = rng.uniform(-70, 70, (m, 2))
        boxes[:, 2] = rng.uniform(-1, 1, m)
        boxes[:, 3:6] = rng.uniform(0.5, 5, (m, 3))
        boxes[:, 6] = rng.uniform(-np.pi, np.pi, m)
        if velocity:
            boxes[:, 7:9] = rng.uniform(-5, 5, (m, 2))
        keep = rng.uniform(0, 1, m) < 0.8
        d = boxes[keep].copy()
        d[:, :3] += rng.normal(0, 0.3, (len(d), 3))
        d[:, 3:6] *= rng.uniform(0.85, 1.15, (len(d), 3))
        d[:, 6] += rng.normal(0, 0.4, len(d))
        n_fp = rng.randint(0, 4)
        fp = np.zeros((n_fp, boxes.shape[1]))
        fp[:, :2] = rng.uniform(-70, 70, (n_fp, 2))
        fp[:, 3:6] = rng.uniform(0.5, 5, (n_fp, 3))
        d = np.concatenate([d, fp])
        d_names = np.concatenate([names[keep],
                                  [classes[i] for i in rng.randint(len(classes), size=n_fp)]])
        scores = np.round(rng.uniform(0, 1, len(d)), 1)  # ties
        gts.append((names, boxes, rng.randint(0, 40, m), rng.randint(0, 3, m)))
        dets.append({"name": d_names.astype(str), "boxes_lidar": d, "score": scores})
    return gts, dets


def test_nuscenes_eval_random_scene_matches_jax():
    rng = np.random.RandomState(0)
    classes = ["car", "truck", "barrier", "traffic_cone", "pedestrian"]
    gts, dets = _scene(rng, 12, classes, velocity=True)
    gt_frames = [{"name": n, "boxes_lidar": b, "num_lidar_pts": p} for n, b, p, _ in gts]
    for pred_velocity in (True, False):
        want = j_nusc.nuscenes_eval(copy.deepcopy(gt_frames), copy.deepcopy(dets), classes,
                                    pred_velocity=pred_velocity)
        got = t_nusc.nuscenes_eval(copy.deepcopy(gt_frames), copy.deepcopy(dets), classes,
                                   pred_velocity=pred_velocity)
        assert_same(got, want)
        assert want[1]["mAP"] > 0


def test_waymo_metrics_random_scene_match_jax():
    rng = np.random.RandomState(1)
    classes = ["Vehicle", "Pedestrian", "Cyclist"]
    gts, dets = _scene(rng, 10, classes, velocity=False)
    gt_annos = [{"name": n, "gt_boxes_lidar": b, "num_points_in_gt": p, "difficulty": d}
                for n, b, p, d in gts]
    want = j_waymo.waymo_detection_metrics(copy.deepcopy(dets), copy.deepcopy(gt_annos),
                                           classes)
    got = t_waymo.waymo_detection_metrics(copy.deepcopy(dets), copy.deepcopy(gt_annos), classes)
    assert_same(got, want)
    assert t_waymo.format_waymo_results(got) == j_waymo.format_waymo_results(want)
    assert max(want.values()) > 0
