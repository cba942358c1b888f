"""Label files and self-training label fusion in the PyTorch port vs the JAX
package (CPU, small sizes): the BEV NMS over a frame's objects (area and
score rank), the PP filter, the FOV filter, the label text, one frame of
the fusion, the dormant PP smoothing, and the label CLIs
(generate_label_files, combine_labels, gen_gt_mask) writing the same files
as the JAX CLIs on the same inputs.
"""
import pickle
import types

import numpy as np
import pytest

from modest_tpu.cli import combine_labels as j_combine_labels
from modest_tpu.cli import gen_gt_mask as j_gen_gt_mask
from modest_tpu.cli import generate_label_files as j_generate_label_files
from modest_tpu.cli.common import load_pipeline_config as j_load_pipeline_config
from modest_tpu.pipeline import clustering as jcl
from modest_tpu.pipeline import seed_labels as jsl
from modest_tpu.utils.kitti_io import Calibration as JCalibration
from modest_tpu_torch.cli import combine_labels, gen_gt_mask, generate_label_files
from modest_tpu_torch.cli.common import load_pipeline_config
from modest_tpu_torch.pipeline import clustering as tcl
from modest_tpu_torch.pipeline import seed_labels as tsl
from modest_tpu_torch.tools.synth_kitti import make_dataset
from modest_tpu_torch.utils import kitti_io
from modest_tpu_torch.utils.kitti_io import Calibration
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CALIB = {"P2": np.array([[700.0, 0, 600, 0], [0, 700.0, 200, 0], [0, 0, 1.0, 0]]),
         "P3": np.array([[700.0, 0, 600, 0], [0, 700.0, 200, 0], [0, 0, 1.0, 0]]),
         "R0_rect": np.eye(3),
         "Tr_velo_to_cam": np.array([[0.0, -1, 0, 0], [0, 0, -1, 0], [1.0, 0, 0, 0]])}


def _objs(seed, n=40, spread=25.0):
    """Camera-frame boxes, many overlapping: n/4 clusters of 4 boxes within
    ~1.5 m of each other, some behind the camera or outside the image."""
    rng = np.random.RandomState(seed)
    objs = []
    centres = np.stack([rng.uniform(-spread, spread, n // 4), rng.uniform(1.0, 2.0, n // 4),
                        rng.uniform(-5, 60, n // 4)], 1)
    for c in centres:
        for _ in range(4):
            o = types.SimpleNamespace()
            o.t = (c + rng.normal(0, 0.6, 3) * [1, 0.05, 1]).astype(np.float32)
            o.l, o.w, o.h = (float(v) for v in rng.uniform([3.5, 1.6, 1.4], [4.8, 2.0, 1.8]))
            o.ry = float(rng.uniform(-np.pi, np.pi))
            o.score = float(rng.uniform(0, 1))
            objs.append(o)
    return objs


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("use_score_rank", [False, True])
def test_objs_nms_keeps_what_jax_keeps(seed, use_score_rank):
    objs = _objs(seed)
    got = tsl.objs_nms(objs, use_score_rank=use_score_rank, nms_threshold=0.1, device="cpu")
    want = jsl.objs_nms(objs, use_score_rank=use_score_rank, nms_threshold=0.1)
    assert [id(o) for o in got] == [id(o) for o in want]
    assert 0 < len(want) < len(objs)
    assert tsl.objs_nms([], device="cpu") == []


def test_bev_boxes_and_fov_equal_jax():
    objs = _objs(3, spread=60.0)
    np.testing.assert_array_equal(tsl.objs_to_bev_boxes(objs), jsl.objs_to_bev_boxes(objs))
    calib, jcalib = Calibration(CALIB), JCalibration(CALIB)
    got = [tsl.is_within_fov(o, calib, (1024, 1224)) for o in objs]
    assert got == [jsl.is_within_fov(o, jcalib, (1024, 1224)) for o in objs]
    assert 0 < sum(got) < len(objs)


@pytest.mark.parametrize("with_score", [False, True])
def test_objs2label_text_equals_jax(with_score):
    objs = _objs(4)
    got = tsl.objs2label(objs, Calibration(CALIB), with_score=with_score)
    assert got == jsl.objs2label(objs, JCalibration(CALIB), with_score=with_score)
    assert len(got.splitlines()) == len(objs)


def _frame(seed):
    """Rect-coordinate points: ground, and dense clusters inside half the
    boxes with low PP (ephemeral) and inside the others with high PP."""
    rng = np.random.RandomState(seed)
    objs = _objs(seed + 10, n=16)
    pts = [np.stack([rng.uniform(-30, 30, 4000), np.full(4000, 1.8),
                     rng.uniform(0, 60, 4000)], 1)]
    pps = [rng.uniform(0.6, 1, 4000)]
    for i, o in enumerate(objs):
        local = rng.uniform(-0.45, 0.45, (200, 3)) * [o.l, o.h, o.w]
        c, s = np.cos(o.ry), np.sin(o.ry)
        x = local[:, 0] * c + local[:, 2] * s
        z = -local[:, 0] * s + local[:, 2] * c
        pts.append(np.stack([x + o.t[0], local[:, 1] + o.t[1] - o.h / 2, z + o.t[2]], 1))
        pps.append(rng.uniform(0, 0.4, 200) if i % 2 else rng.uniform(0.55, 1, 200))
    return objs, np.concatenate(pts).astype(np.float32), np.concatenate(pps).astype(np.float32)


def test_filter_by_ppscore_equals_jax():
    objs, ptc_rect, pp = _frame(0)
    for percentile, threshold in ((50, 0.5), (20, 0.3), (90, 0.9)):
        got = [tsl.filter_by_ppscore(ptc_rect, pp, o, percentile, threshold) for o in objs]
        assert got == [jsl.filter_by_ppscore(ptc_rect, pp, o, percentile, threshold)
                       for o in objs]
        assert 0 < sum(got) < len(objs), (percentile, threshold)


def _preds(objs):
    return {"location": np.array([o.t for o in objs], np.float32).reshape(-1, 3),
            "dimensions": np.array([[o.l, o.h, o.w] for o in objs], np.float32).reshape(-1, 3),
            "rotation_y": np.array([o.ry for o in objs], np.float32),
            "score": np.array([o.score for o in objs], np.float32)}


@pytest.mark.parametrize("overrides", [[], ["fov_only=false", "det_filtering.score_filtering=0.3"]])
def test_combine_labels_for_frame_equals_jax(overrides):
    objs, ptc_rect, pp = _frame(1)
    seeds = _objs(20, n=12)
    ov = ["data_root=/d"] + overrides
    cfg = load_pipeline_config("combine_labels", ov)
    j_cfg = j_load_pipeline_config("combine_labels", ov)
    got = tsl.combine_labels_for_frame(_preds(objs), [types.SimpleNamespace(**vars(o))
                                                      for o in seeds],
                                       ptc_rect, pp, Calibration(CALIB), cfg, device="cpu")
    want = jsl.combine_labels_for_frame(_preds(objs), [types.SimpleNamespace(**vars(o))
                                                       for o in seeds],
                                        ptc_rect, pp, JCalibration(CALIB), j_cfg)
    assert tsl.objs2label(got, Calibration(CALIB), with_score=True) == jsl.objs2label(
        want, JCalibration(CALIB), with_score=True)
    assert len(got) > 0
    # the area-scored seed boxes and PP-kept detections both survive somewhere
    assert any(o.score < 0 for o in got) and any(o.score >= 0 for o in got)


@pytest.mark.parametrize("neighbor_type", ["knn", "radius"])
def test_smooth_pp_score_equals_jax(neighbor_type):
    """Dormant in the reference and the JAX package; the graph and weights
    come from float32 distances, which JAX forms as one fused dot and the
    port as an elementwise chain: scores agree within 1e-5."""
    rng = np.random.RandomState(5)
    ptc = np.concatenate([rng.uniform(-10, 10, (700, 3)),
                          rng.normal(0, 0.5, (300, 3)) + [3, 3, 0]]).astype(np.float32)
    pp = rng.uniform(0, 1, len(ptc)).astype(np.float32)
    kw = dict(neighbor_type=neighbor_type, n_neighbors=20, radius=1.0, num_iterations=10)
    got = tcl.smooth_pp_score(ptc, pp, device="cpu", **kw)
    want = jcl.smooth_pp_score(ptc, pp, **kw)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.abs(got - pp).max() > 0.1  # it smoothed
    np.testing.assert_array_equal(tcl.smooth_pp_score(ptc[:0], pp[:0], device="cpu"), pp[:0])


# ---------------------------------------------------------------------------
# the CLIs on the same inputs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def label_root(tmp_path_factory):
    """tools/synth_kitti.py frames with their labels, and per frame: seed
    boxes (perturbed copies of the labels and overlapping extras, pickled),
    PP scores (low inside the labelled boxes) and a detector result.pkl of
    noisy label boxes, one frame behind the camera."""
    root = tmp_path_factory.mktemp("label_fusion")
    make_dataset(root, n_train=5, n_val=0, seed=11)
    rng = np.random.RandomState(12)
    ids = [f"{i:06d}" for i in range(5)]
    (root / "idx.txt").write_text("".join(f"{int(i)}\n" for i in ids))
    for sub in ("bbox", "pp"):
        (root / sub).mkdir()
    results = []
    for fid in ids:
        labels = kitti_io.read_label(root / "training" / "label_2" / f"{fid}.txt")
        objs = []
        for lab in labels:
            for _ in range(3):
                o = types.SimpleNamespace(t=np.asarray(lab.t) + rng.normal(0, 0.4, 3) * [1, 0, 1],
                                          l=lab.l * rng.uniform(0.9, 1.1), w=lab.w, h=lab.h,
                                          ry=lab.ry + rng.normal(0, 0.2))
                objs.append(o)
        objs.append(types.SimpleNamespace(t=np.array([0.0, 1.5, -8.0]), l=4.0, w=1.8, h=1.5,
                                          ry=0.3))  # behind the camera
        with open(root / "bbox" / f"{fid}.pkl", "wb") as f:
            pickle.dump(objs, f)
        scan = kitti_io.load_velo_scan(root / "training" / "velodyne" / f"{fid}.bin")
        pp = rng.uniform(0.6, 1.0, len(scan)).astype(np.float32)
        pp[-300 * len(labels):] = rng.uniform(0, 0.3, 300 * len(labels))  # the cars' points
        np.save(root / "pp" / f"{fid}.npy", pp)
        dets = labels + [labels[0]] if labels else []
        results.append({
            "frame_id": fid,
            "name": np.array(["Dynamic"] * len(dets)),
            "location": np.array([np.asarray(d.t) + rng.normal(0, 0.3, 3) * [1, 0, 1]
                                  for d in dets], np.float32).reshape(-1, 3),
            "dimensions": np.array([[d.l, d.h, d.w] for d in dets], np.float32).reshape(-1, 3),
            "rotation_y": np.array([d.ry for d in dets], np.float32),
            "score": rng.uniform(0.2, 1, len(dets)).astype(np.float32),
        })
    with open(root / "result.pkl", "wb") as f:
        pickle.dump(results, f)
    return root


def _overrides(root):
    return [f"work_dir={root}", f"data_root={root / 'training'}",
            f"data_paths.idx_list={root / 'idx.txt'}",
            f"data_paths.bbox_info_save_dst={root / 'bbox'}",
            f"data_paths.pp_score_path={root / 'pp'}"]


def _texts(d):
    return {p.name: p.read_text() for p in sorted(d.iterdir())}


def test_generate_label_files_writes_what_jax_writes(label_root):
    j_generate_label_files.main(_overrides(label_root)
                                + [f"data_paths.label_file_save_dst={label_root / 'j_labels'}"])
    generate_label_files.main(_overrides(label_root)
                              + [f"data_paths.label_file_save_dst={label_root / 'labels'}",
                                 "device=cpu"])
    got, want = _texts(label_root / "labels"), _texts(label_root / "j_labels")
    assert got == want and len(got) == 5
    n_lines = sum(len(t.splitlines()) for t in got.values())
    n_seed = sum(len(pickle.load(open(p, "rb"))) for p in (label_root / "bbox").iterdir())
    assert 5 <= n_lines < n_seed  # the NMS and the FOV filter dropped boxes


@pytest.mark.parametrize("extra", [[], ["total_part=2", "part=1", "with_score=true"]])
def test_combine_labels_writes_what_jax_writes(label_root, extra):
    tag = "_".join(extra) or "all"
    ov = _overrides(label_root) + [f"det_result_path={label_root / 'result.pkl'}"] + extra
    j_combine_labels.main(ov + [f"save_path={label_root / ('j_fused_' + tag)}"])
    combine_labels.main(ov + [f"save_path={label_root / ('fused_' + tag)}", "device=cpu"])
    got = _texts(label_root / f"fused_{tag}")
    assert got == _texts(label_root / f"j_fused_{tag}")
    assert len(got) == (5 if not extra else 2)  # part 1 of 2 of 5 positions: 2
    assert sum(len(t.splitlines()) for t in got.values()) >= len(got)


def test_gen_gt_mask_writes_what_jax_writes(label_root):
    args = ["--data_root", str(label_root / "training"), "--idx_list",
            str(label_root / "idx.txt")]
    j_gen_gt_mask.main(args + ["--save_dir", str(label_root / "j_gt_mask")])
    gen_gt_mask.main(args + ["--save_dir", str(label_root / "gt_mask")])
    for i in range(5):
        got = np.load(label_root / "gt_mask" / f"{i:06d}.npy")
        np.testing.assert_array_equal(got, np.load(label_root / "j_gt_mask" / f"{i:06d}.npy"))
        assert got.max() >= 1


@pytest.mark.parametrize("cli", ["generate_label_files", "combine_labels"])
def test_label_clis_run_on_the_card_unless_asked_for_the_cpu(label_root, cli, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card; the refusal needs a host without one")
    main = {"generate_label_files": generate_label_files.main,
            "combine_labels": combine_labels.main}[cli]
    ov = _overrides(label_root) + [f"data_paths.label_file_save_dst={tmp_path}",
                                   f"det_result_path={label_root / 'result.pkl'}",
                                   f"save_path={tmp_path}"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(ov)
