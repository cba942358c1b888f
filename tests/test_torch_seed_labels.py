"""Seed-label path in the PyTorch port vs the JAX package (CPU, small sizes).

kNN graphs, DBSCAN labels, the closeness angle scan, the cluster filters,
whole frames through ``generate_mask_for_frame(s)``, and the pipeline
config dicts, each against the JAX function on the same numpy inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modest_tpu.cli.common import load_pipeline_config as j_load_pipeline_config
from modest_tpu.pipeline import box_fit as jbf
from modest_tpu.pipeline import clustering as jcl
from modest_tpu.pipeline import seed_labels as jsl
from modest_tpu.utils.config import Config as JConfig
from modest_tpu.utils.config import cfg_from_yaml_file as j_cfg_from_yaml_file
from modest_tpu.utils.kitti_io import Calibration as JCalibration
from modest_tpu_torch.cli.common import load_pipeline_config
from modest_tpu_torch.configs import PIPELINE_CONFIGS, PIPELINE_DATA_PATHS
from modest_tpu_torch.pipeline import box_fit as tbf
from modest_tpu_torch.pipeline import clustering as tcl
from modest_tpu_torch.pipeline import seed_labels as tsl
from modest_tpu_torch.utils.config import Config, parse_value
from modest_tpu_torch.utils.kitti_io import Calibration

CALIB = {"P2": np.array([[700.0, 0, 600, 0], [0, 700.0, 200, 0], [0, 0, 1.0, 0]]),
         "P3": np.array([[700.0, 0, 600, 0], [0, 700.0, 200, 0], [0, 0, 1.0, 0]]),
         "R0_rect": np.eye(3),
         "Tr_velo_to_cam": np.array([[0.0, -1, 0, 0], [0, 0, -1, 0], [1.0, 0, 0, 0]])}
MASK_CFG = {
    "plane_estimate": {"range": [[-70, 70], [-20, 20]], "max_hs": -1.5, "offset": 0.05},
    "limit_range": [[-70, 70], [-40, 40]],
    "graph": {"neighbor_type": "radius_mutual_knn", "affinity_type": "l1",
              "n_neighbors": 30, "radius": 2.0},
    "clustering": {"method": "DBSCAN", "DBSCAN": {"eps": 0.1, "min_samples": 8}},
    "filtering": {"min_points": 10, "max_volume": 120, "min_volume": 0.5, "min_max_height": 0.5,
                  "max_min_height": 1.0, "percentile": 20, "min_percentile_pp_score": 0.7},
    "bbox_gen": {"fit_method": "closeness_to_edge"},
}


def _blob_frame(seed, n=3000, blobs=4):
    r = np.random.RandomState(seed)
    xyz = r.uniform(-30, 30, (n, 3)).astype(np.float32)
    pp = r.uniform(0, 1, n).astype(np.float32)
    for b in range(blobs):
        c = r.uniform(-20, 20, 3)
        sl = slice(b * 150, (b + 1) * 150)
        xyz[sl] = (c + r.uniform(-0.8, 0.8, (150, 3))).astype(np.float32)
        pp[sl] = 0.1 + r.uniform(0, 0.05, 150).astype(np.float32)
    return xyz, pp


def _scene(seed, n_ground=6000):
    """Ground (persistent) + four ephemeral car-sized boxes, as velodyne
    (N, 4) points and their PP scores."""
    r = np.random.RandomState(seed)
    ground = np.stack([r.uniform(0, 70, n_ground), r.uniform(-30, 30, n_ground),
                       r.normal(-1.8, 0.03, n_ground)], 1)
    pts = [ground]
    for _ in range(4):
        c = r.uniform([10, -20, -1.5], [60, 20, -1.2])
        pts.append(c + r.uniform(-1, 1, (400, 3)) * [2.0, 0.9, 0.7])
    ptc = np.concatenate(pts).astype(np.float32)
    ptc = np.concatenate([ptc, np.zeros((len(ptc), 1), np.float32)], 1)
    pp = r.uniform(0, 1, len(ptc)).astype(np.float32)
    pp[:n_ground] = 0.85
    pp[n_ground:] = 0.05
    return ptc, pp


def _assert_knn_close(x, n, idx, d2, j_idx, j_d2):
    """The port rounds the expansion q_sq + c_sq − 2·q·c in float32
    elementwise steps, XLA's CPU dot as a fused multiply-add chain: over the
    n real rows, d2 agrees within 8 float32 roundings at the scale of the
    expansion's terms, and idx is equal except where the two chosen
    neighbours lie at float64 distances that close (a near tie)."""
    x64 = x.astype(np.float64)
    sq = (x64 * x64).sum(1)
    idx, d2, j_idx, j_d2 = idx[:n], d2[:n], j_idx[:n], j_d2[:n]
    tol = 8 * 2.0 ** -24 * (sq[:n, None] + sq[j_idx])
    finite = np.isfinite(j_d2)
    np.testing.assert_array_equal(np.isfinite(d2), finite)
    assert (np.abs(d2 - j_d2)[finite] <= tol[finite]).all()
    differ = idx != j_idx
    assert differ.mean() < 0.01
    true = ((x64[:n, None] - x64[idx]) ** 2).sum(-1)
    j_true = ((x64[:n, None] - x64[j_idx]) ** 2).sum(-1)
    assert (np.abs(true - j_true)[differ & finite] <= 2 * tol[differ & finite]).all()


@pytest.mark.parametrize("windowed", [False, True])
def test_knn_matches_jax(windowed):
    xyz, pp = _blob_frame(0)
    n_pad = jcl._bucket(len(xyz), 256)
    order, x, p, valid, need = jcl._dbscan_prep(xyz, pp, n_pad, 2.0, 256)
    k = 30
    if windowed:
        w = jcl._window_width(need, k, 256)
        assert w < n_pad
        j_idx, j_d2 = jcl._knn_windowed(jnp.asarray(x), jnp.asarray(valid), k, 256, w, 2.0)
        idx, d2 = tcl._knn_windowed(torch.from_numpy(x)[None], torch.from_numpy(valid)[None],
                                    k, 256, w, 2.0)
    else:
        j_idx, j_d2 = jcl._knn(jnp.asarray(x), jnp.asarray(valid), k, row_chunk=256)
        idx, d2 = tcl._knn(torch.from_numpy(x)[None], torch.from_numpy(valid)[None], k, 256)
    assert idx.dtype == torch.int32 and d2.dtype == torch.float32
    _assert_knn_close(x, len(xyz), idx[0].numpy(), d2[0].numpy(), np.asarray(j_idx),
                      np.asarray(j_d2))


def test_knn_ties_go_to_the_lower_index():
    """Integer grid points: many exactly equal distances (every product and
    sum is exact in float32, so both roundings give the same bits)."""
    g = np.stack(np.meshgrid(np.arange(8), np.arange(8), np.arange(4), indexing="ij"), -1)
    x = g.reshape(-1, 3).astype(np.float32)
    valid = np.ones(len(x), bool)
    j_idx, j_d2 = jcl._knn(jnp.asarray(x), jnp.asarray(valid), 12, row_chunk=256)
    idx, d2 = tcl._knn(torch.from_numpy(x)[None], torch.from_numpy(valid)[None], 12, 256)
    np.testing.assert_array_equal(d2[0].numpy(), np.asarray(j_d2))
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(j_idx))


@pytest.mark.parametrize("seed", [0, 1])
def test_dbscan_pp_matches_jax_and_many_matches_single(seed):
    frames = [_blob_frame(seed + 10 * i, n) for i, n in enumerate([3000, 1500, 2600])]
    kw = dict(n_neighbors=20, radius=2.0, eps=0.15, min_samples=5, row_chunk=256)
    many = tcl.dbscan_pp_many(frames, **kw, device="cpu")
    for (xyz, pp), got in zip(frames, many):
        single = tcl.dbscan_pp(xyz, pp, **kw, device="cpu")
        np.testing.assert_array_equal(got, single)
        np.testing.assert_array_equal(single, jcl.dbscan_pp(xyz, pp, **kw))
        assert single.max() >= 3  # the blobs cluster
    assert tcl.dbscan_pp_many([], device="cpu") == []
    assert tcl.dbscan_pp(np.zeros((0, 3), np.float32), np.zeros(0, np.float32),
                         device="cpu").shape == (0,)


def test_closeness_angles_within_one_step_of_jax():
    rng = np.random.RandomState(2)
    clusters = []
    for i in range(12):
        n = 40 + 70 * i
        ang = rng.uniform(0, np.pi)
        rot = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
        pts = rng.uniform(-0.5, 0.5, (n, 2)) * [4.0, 1.8]
        clusters.append((pts @ rot.T + rng.uniform(-30, 30, 2)).astype(np.float32))
    got = np.array(tbf.closeness_angles_batched(clusters, device="cpu"))
    want = np.array(jbf.closeness_angles_batched(clusters))
    assert np.abs(got - want).max() <= 0.1 / 180 * np.pi + 1e-9


def test_filter_labels_matches_jax():
    ptc, pp = _scene(3)
    rng = np.random.RandomState(3)
    labels = rng.randint(-1, 12, len(ptc))
    labels[6000:] = 12 + np.arange(1600) // 400
    np.testing.assert_array_equal(
        tsl.filter_labels(ptc, pp, labels, **MASK_CFG["filtering"]),
        jsl.filter_labels(ptc, pp, labels, **MASK_CFG["filtering"]))


def _match_boxes(objs, j_objs):
    assert len(objs) == len(j_objs) > 0
    for o, jo in zip(objs, j_objs):
        np.testing.assert_allclose(o.t, jo.t, atol=1e-4)
        np.testing.assert_allclose([o.l, o.w, o.h, o.ry, o.volume],
                                   [jo.l, jo.w, jo.h, jo.ry, jo.volume], atol=1e-4)


def test_generate_mask_for_frames_matches_jax():
    frames = [_scene(40 + s) for s in range(2)]
    cfg, j_cfg = Config(MASK_CFG), JConfig(MASK_CFG)
    calib, j_calib = Calibration(CALIB), JCalibration(CALIB)
    batched = tsl.generate_masks_for_frames(frames, [calib, calib], cfg, device="cpu")
    j_batched = jsl.generate_masks_for_frames(frames, [j_calib, j_calib], j_cfg)
    for (ptc, pp), (labels, objs), (j_labels, j_objs) in zip(frames, batched, j_batched):
        np.testing.assert_array_equal(labels, j_labels)
        _match_boxes(objs, j_objs)
        s_labels, s_objs = tsl.generate_mask_for_frame(ptc, pp, calib, cfg, device="cpu")
        np.testing.assert_array_equal(s_labels, labels)
        _match_boxes(s_objs, objs)
        assert labels.max() == len(objs) >= 3


def test_pipeline_dicts_equal_the_yaml():
    root = "configs/pipeline"
    for name, d in PIPELINE_CONFIGS.items():
        assert j_cfg_from_yaml_file(f"{root}/{name}.yaml").to_dict() == d, name
    for name, d in PIPELINE_DATA_PATHS.items():
        assert j_cfg_from_yaml_file(f"{root}/data_paths/{name}.yaml").to_dict() == d, name


@pytest.mark.parametrize("name,overrides", [
    ("pp_score", ["work_dir=/w", "data_root=/d", "max_neighbor_dist=0.5", "nusc=true"]),
    ("pp_score", ["data_paths=nusc", "work_dir=/w", "limit_traversals=3"]),
    ("generate_mask", ["work_dir=/w", "data_root=/d", "graph.n_neighbors=30",
                       "limit_range=[[-10, 10], [-5, 5]]", "bbox_gen.fit_method=PCA"]),
])
def test_load_pipeline_config_matches_jax(name, overrides):
    got = load_pipeline_config(name, overrides).to_dict()
    assert got == j_load_pipeline_config(name, overrides).to_dict()
    assert "${" not in str(got)


@pytest.mark.parametrize("text", ["30", "-1", "0.3", "1.5e-3", "true", "False", "YES", "off",
                                  "null", "~", "", "[[-10, 10], [-5, 5]]", "/data/x", "PCA",
                                  '"quoted"'])
def test_override_values_parse_as_pyyaml_does(text):
    import yaml

    got, want = parse_value(text), yaml.safe_load(text)
    assert got == want and type(got) is type(want)


def test_entry_points_run_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the refusal needs a host without one")
    xyz, pp = _blob_frame(0, 1000)
    ptc, spp = _scene(0)
    for call in (lambda: tcl.dbscan_pp(xyz, pp),
                 lambda: tcl.dbscan_pp_many([(xyz, pp)]),
                 lambda: tsl.generate_mask_for_frame(ptc, spp, Calibration(CALIB), Config(MASK_CFG)),
                 lambda: tsl.generate_masks_for_frames([(ptc, spp)], [Calibration(CALIB)],
                                                       Config(MASK_CFG))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
