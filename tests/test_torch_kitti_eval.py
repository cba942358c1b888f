"""The port's KITTI AP harness (modest_tpu_torch/eval/kitti_eval.py) against
the JAX package's on seeded random annos, with and without the host
library, its native matcher against the numpy one, and the cases of
tests/test_kitti_eval.py (there marked slow) run on the port, including the
evaluate CLI on label directories.

The JAX harness runs with its host library throughout (without it, its BEV
overlaps compile an XLA program per frame shape). The port without the
library takes its overlaps from ops/iou3d.py on CPU tensors in float32
against the library's float64: AP depends on the overlaps only through
``overlap > min_overlap``, so the results must still be equal.
"""
import numpy as np
import pytest

from modest_tpu.eval import kitti_eval as j_kitti_eval
from modest_tpu_torch.cli import evaluate as evaluate_cli
from modest_tpu_torch.eval import kitti_eval
from modest_tpu_torch.tools.synth_kitti import make_dataset
from modest_tpu_torch.utils import native
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _random_annos(seed, n_frames=24, classes=("Dynamic", "Car")):
    """gt frames of 0–6 boxes and detections near them (shifts up to ~1 m,
    so some pass IoU 0.7 and some only 0.25; 2D boxes a few pixels off)
    plus false positives; 2D boxes of varied height, truncation and
    occlusion, so every difficulty keeps and drops some; alpha set, so the
    bbox metric also scores orientation."""
    rng = np.random.RandomState(seed)
    gts, dts = [], []

    def boxes2d(n):
        top, left = rng.uniform(100, 300, n), rng.uniform(0, 1000, n)
        return np.stack([left, top, left + rng.uniform(20, 200, n),
                         top + rng.uniform(15, 120, n)], 1).reshape(n, 4)

    def anno(locs, dims, rys, names, scores, bbox):
        n = len(locs)
        return {
            "name": np.array(names, dtype="<U32"),
            "truncated": rng.choice([0.0, 0.2, 0.4, 0.8], n),
            "occluded": rng.randint(0, 4, n).astype(float),
            "alpha": rng.uniform(-np.pi, np.pi, n),
            "bbox": bbox,
            "dimensions": np.asarray(dims, float).reshape(n, 3),
            "location": np.asarray(locs, float).reshape(n, 3),
            "rotation_y": np.asarray(rys, float).reshape(n),
            "score": np.asarray(scores, float).reshape(n),
        }

    for _ in range(n_frames):
        n = rng.randint(0, 7)
        locs = np.stack([rng.uniform(-20, 20, n), rng.uniform(0.5, 2, n),
                         rng.uniform(3, 85, n)], 1)
        dims = np.stack([rng.uniform(3.5, 5, n), rng.uniform(1.4, 1.8, n),
                         rng.uniform(1.6, 2.0, n)], 1)
        rys = rng.uniform(-np.pi, np.pi, n)
        names = list(rng.choice(classes, n))
        bbox = boxes2d(n)
        gts.append(anno(locs, dims, rys, names, np.zeros(n), bbox))
        hit = rng.rand(n) < 0.8
        m = int(hit.sum())
        fp = rng.randint(0, 3)
        d_locs = np.concatenate([locs[hit] + rng.normal(0, 0.4, (m, 3)) * [1, 0.1, 1],
                                 np.stack([rng.uniform(-20, 20, fp), np.ones(fp),
                                           rng.uniform(3, 85, fp)], 1)])
        d_dims = np.concatenate([dims[hit] * rng.uniform(0.9, 1.1, (m, 3)),
                                 np.tile([4.2, 1.5, 1.8], (fp, 1))])
        d_rys = np.concatenate([rys[hit] + rng.normal(0, 0.1, m), rng.uniform(-3, 3, fp)])
        d_names = [names[i] for i in np.flatnonzero(hit)] + list(rng.choice(classes, fp))
        d_bbox = np.concatenate([bbox[hit] + rng.normal(0, 4, (m, 4)), boxes2d(fp)])
        dts.append(anno(d_locs, d_dims, d_rys, d_names, rng.uniform(0.05, 1, m + fp), d_bbox))
    return gts, dts


@pytest.fixture(params=["library", "no_library"])
def host_library(request, monkeypatch):
    """The port's harness with its host library, or with ``get_lib`` giving
    None (the overlaps from ops/iou3d.py, the numpy matcher)."""
    if request.param == "no_library":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    else:
        assert native.available(), "the host library does not build here"
    return request.param


@pytest.mark.parametrize("fn", ["get_official_eval_result", "get_range_eval_result",
                                "get_coco_eval_result"])
def test_results_equal_jax(fn, host_library):
    gts, dts = _random_annos(0)
    classes = ["Dynamic", "Car"]
    got_str, got = getattr(kitti_eval, fn)(gts, dts, classes)
    want_str, want = getattr(j_kitti_eval, fn)(gts, dts, classes)
    assert got_str == want_str
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert any(v > 0 for v in want.values()), "every AP is 0: the comparison is vacuous"


def test_match_stats_equals_the_numpy_matcher():
    """The host matcher's (tp, fp, fn) per threshold equal
    compute_statistics (compute_fp, no DontCare boxes) on random frames."""
    rng = np.random.RandomState(1)
    for _ in range(30):
        n_dt, n_gt = rng.randint(0, 9), rng.randint(0, 7)
        overlaps = np.where(rng.rand(n_dt, n_gt) < 0.4, rng.rand(n_dt, n_gt), 0.0)
        scores = rng.rand(n_dt)
        ig_gt = rng.choice([-1, 0, 0, 1], n_gt)
        ig_dt = rng.choice([-1, 0, 0, 1], n_dt)
        thresholds = np.sort(rng.rand(rng.randint(1, 8)))[::-1]
        got = native.match_stats(overlaps, scores, ig_gt, ig_dt, 0.5, thresholds)
        dt_datas = np.concatenate([np.zeros((n_dt, 5)), scores[:, None]], 1)
        for t, thr in enumerate(thresholds):
            tp, fp, fn, _, _ = kitti_eval.compute_statistics(
                overlaps, np.zeros((n_gt, 5)), dt_datas, ig_gt, ig_dt, np.zeros((0, 4)), 1,
                min_overlap=0.5, thresh=thr, compute_fp=True)
            assert tuple(got[t]) == (tp, fp, fn)


def test_match_stats_is_none_without_the_library(monkeypatch):
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert native.match_stats(np.zeros((1, 1)), np.ones(1), [0], [0], 0.5, [0.5]) is None


# ---------------------------------------------------------------------------
# tests/test_kitti_eval.py's cases, on the port
# ---------------------------------------------------------------------------


def make_anno(locs, dims, rys, names=None, scores=None):
    n = len(locs)
    return {
        "name": np.array(names if names is not None else ["Dynamic"] * n),
        "truncated": np.full(n, -1.0),
        "occluded": np.full(n, -1.0),
        "alpha": np.zeros(n),
        "bbox": np.tile(np.array([0.0, 0.0, 100.0, 100.0]), (n, 1)),
        "dimensions": np.asarray(dims, float).reshape(n, 3),
        "location": np.asarray(locs, float).reshape(n, 3),
        "rotation_y": np.asarray(rys, float).reshape(n),
        "score": np.asarray(scores if scores is not None else [1.0] * n, float),
    }


def test_perfect_detections_ap100():
    # R40 interpolation needs >= 41 gt objects to fill every recall sample
    gt, dt = [], []
    rng = np.random.RandomState(0)
    for _ in range(15):
        locs = rng.uniform(5, 25, (3, 3)) * [1, 0.1, 1]
        dims = rng.uniform(1.5, 4, (3, 3))
        rys = rng.uniform(-np.pi, np.pi, 3)
        gt.append(make_anno(locs, dims, rys))
        dt.append(make_anno(locs, dims, rys, scores=rng.uniform(0.5, 1.0, 3)))
    _, ret = kitti_eval.get_range_eval_result(gt, dt, ["Dynamic"], ranges=(0, 30, 50, 80))
    assert ret["Dynamic_bev_iou0.7/00-80_R40"] > 99.9
    assert ret["Dynamic_3d_iou0.7/00-80_R40"] > 99.9
    assert ret["Dynamic_bev_iou0.5/00-80_R40"] > 99.9


def test_missed_detection_lowers_ap():
    gt, dt = [], []
    for f in range(45):
        locs = np.array([[5.0, 0, 10.0 + 0.1 * f], [15.0, 0, 20.0 + 0.1 * f]])
        dims = np.tile([4.0, 1.5, 1.8], (2, 1))
        gt.append(make_anno(locs, dims, np.zeros(2)))
        dt.append(make_anno(locs[:1], dims[:1], np.zeros(1), scores=[0.9]))  # the first only
    _, ret = kitti_eval.get_range_eval_result(gt, dt, ["Dynamic"])
    assert 30 < ret["Dynamic_bev_iou0.7/00-80_R40"] < 60  # recall caps at 50%


def test_false_positives_lower_precision():
    gt, dt = [], []
    dims = np.array([[4.0, 1.5, 1.8]])
    for _ in range(45):
        gt.append(make_anno(np.array([[5.0, 0, 10.0]]), dims, [0.0]))
        # 1 TP + 1 higher-scored FP far away
        dt.append(make_anno(np.array([[5.0, 0, 10.0], [50.0, 0, 70.0]]), np.tile(dims, (2, 1)),
                            [0.0, 0.0], scores=[0.8, 0.9]))
    _, ret = kitti_eval.get_range_eval_result(gt, dt, ["Dynamic"])
    assert 40 < ret["Dynamic_bev_iou0.7/00-80_R40"] < 60  # precision 0.5 at full recall


def test_range_bucketing():
    locs = [[5.0, 0, 20.0], [5.0, 0, 40.0]]
    dims = np.tile([4.0, 1.5, 1.8], (2, 1))
    gt = [make_anno(locs, dims, [0.0, 0.0]) for _ in range(45)]
    dt = [make_anno(locs, dims, [0.0, 0.0], scores=[0.9, 0.9]) for _ in range(45)]
    _, ret = kitti_eval.get_range_eval_result(gt, dt, ["Dynamic"], ranges=(0, 30, 50, 80))
    assert ret["Dynamic_bev_iou0.7/00-30_R40"] > 99.9  # only the 20 m box
    assert ret["Dynamic_bev_iou0.7/30-50_R40"] > 99.9  # only the 40 m box
    assert ret["Dynamic_bev_iou0.7/50-80_R40"] == 0.0  # an empty bucket


def test_iou_threshold_mapping():
    """Boxes shifted 2 m (IoU 0.33) pass IoU 0.25 (the 'iou0.5' column) and
    fail IoU 0.5 (the 'iou0.7' column): the Dynamic min_overlaps quirk."""
    gt = [make_anno([[5.0, 0, 20.0]], [[4.0, 1.5, 1.8]], [0.0]) for _ in range(45)]
    dt = [make_anno([[7.0, 0, 20.0]], [[4.0, 1.5, 1.8]], [0.0], scores=[0.9]) for _ in range(45)]
    _, ret = kitti_eval.get_range_eval_result(gt, dt, ["Dynamic"])
    assert ret["Dynamic_bev_iou0.5/00-80_R40"] > 99.9
    assert ret["Dynamic_bev_iou0.7/00-80_R40"] < 1.0


def test_get_thresholds_41_points():
    th = kitti_eval.get_thresholds(np.linspace(0, 1, 200), 200)
    assert len(th) <= 41
    assert all(th[i] >= th[i + 1] for i in range(len(th) - 1))
    assert th == j_kitti_eval.get_thresholds(np.linspace(0, 1, 200), 200)


def test_official_eval_runs():
    gt = [make_anno([[5.0, 0, 20.0]], [[4.0, 1.5, 1.8]], [0.0], names=["Car"]) for _ in range(45)]
    dt = [make_anno([[5.0, 0, 20.0]], [[4.0, 1.5, 1.8]], [0.0], names=["Car"], scores=[0.9])
          for _ in range(45)]
    _, ret = kitti_eval.get_official_eval_result(gt, dt, ["Car"])
    assert ret["Car_bev/easy_R40"] > 99.9


def test_ap_from_lidar_annos_equals_jax():
    rng = np.random.RandomState(2)
    gts, dts = [], []
    for _ in range(10):
        n = rng.randint(0, 5)
        boxes = np.concatenate([rng.uniform(-30, 30, (n, 2)), np.zeros((n, 1)),
                                rng.uniform(1.5, 4.5, (n, 3)), rng.uniform(-3, 3, (n, 1))], 1)
        gts.append({"name": np.array(["car"] * n), "boxes_lidar": boxes})
        det = boxes + rng.normal(0, 0.3, boxes.shape) * [1, 1, 0, 0.1, 0.1, 0, 0.1]
        dts.append({"name": np.array(["car"] * n), "boxes_lidar": det,
                    "score": rng.rand(n)})
    got = kitti_eval.ap_from_lidar_annos(gts, dts, ["car"])
    assert got == j_kitti_eval.ap_from_lidar_annos(gts, dts, ["car"])
    assert got[1]["car_bev_iou0.5_R40"] > 0


def test_evaluate_cli_offline_label_dirs(tmp_path):
    """cli/evaluate.py: label dir against label dir, no model; evaluating
    the gt with distinct scores reproduces the library path exactly."""
    root = tmp_path / "kitti"
    make_dataset(root, n_train=4, n_val=0, seed=5)
    gt_dir = root / "training" / "label_2"
    det_dir = root / "training" / "dets"
    det_dir.mkdir()
    for p in gt_dir.glob("*.txt"):
        lines = [ln for ln in p.read_text().splitlines() if ln.strip()]
        (det_dir / p.name).write_text(
            "\n".join(f"{ln} {0.9 - 0.01 * i:.2f}" for i, ln in enumerate(lines)) + "\n")

    res = evaluate_cli.main(["--label_path", str(gt_dir), "--result_path", str(det_dir),
                             "--metric", "range"])
    assert "Dynamic_bev_iou0.7/00-80_R40" in res
    gt, det = evaluate_cli.get_label_annos(gt_dir), evaluate_cli.get_label_annos(det_dir)
    _, want = kitti_eval.get_range_eval_result(gt, det, "Dynamic")
    for k, v in want.items():
        np.testing.assert_allclose(res[k], v)
    assert res["Dynamic_bev_iou0.7/00-80_R40"] > 0
    # the JAX CLI reads the same directories to the same numbers
    from modest_tpu.cli import evaluate as j_evaluate_cli

    j_res = j_evaluate_cli.main(["--label_path", str(gt_dir), "--result_path", str(det_dir),
                                 "--metric", "range"])
    assert {k: float(v) for k, v in res.items()} == {k: float(v) for k, v in j_res.items()}

    # a score filter that drops everything → AP 0
    res0 = evaluate_cli.main(["--label_path", str(gt_dir), "--result_path", str(det_dir),
                              "--metric", "range", "--score_thresh", "0.95"])
    assert res0["Dynamic_bev_iou0.7/00-80_R40"] == 0
