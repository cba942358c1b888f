"""PV-RCNN in modest_tpu_torch against the JAX package: the tiny config of
tests/test_pv_rcnn.py::pvrcnn_model_cfg (copied below, on the tiny SECOND of
tests/test_torch_grid_detectors.py), JAX's initial weights carried over by
``models/convert.py::pvrcnn_state_dict_from_jax``, the same toy batch. One
JAX train forward (with the key its RoI sampler drew from) and one eval
forward are shared by the module; no JAX gradient of the whole model is
taken. Also the pieces alone (bilinear BEV interpolation, voxel centres,
RoI grid points, the masked ball query, the multi-scale sparse backbone, a
VSA source's forward and gradient), the plain FPS past the cluster kernel's
former 32768-point cap against JAX's XLA loop, the shipped config dicts
against the YAML file, and the tiny model through cli/train.py (with the
eval after training), cli/test.py and one round of cli/self_train.py on the
CPU."""
from __future__ import annotations

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modest_tpu.models import pv_rcnn as jpv
# imported before any jit: its module constants must not be made under a trace
from modest_tpu.models import sparse_conv as jsc
from modest_tpu.ops import pointnet2_stack as jstack
from modest_tpu.ops.pointnet2 import _furthest_point_sample_xla
from modest_tpu.utils.config import Config as JConfig
from modest_tpu_torch.models import api, build_network
from modest_tpu_torch.models import pv_rcnn as pv
from modest_tpu_torch.models.convert import mlp_state_from_jax, pvrcnn_state_dict_from_jax
from modest_tpu_torch.models.voxelize import point_voxel_coords, voxelize_sparse
from modest_tpu_torch.ops import pointnet2_stack as stack
from modest_tpu_torch.ops.fps import furthest_point_sample_plain
from modest_tpu_torch.utils.config import Config
from tests.test_torch_grid_detectors import GEOMETRY, PCR, geometry, second_model_cfg, toy_batch
from tests.test_torch_losses import jax_draws
from tests.test_torch_self_train import seeded  # noqa: F401  (the module fixture)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

MAX_VOXELS = 512
VS, GS, GT_XY = GEOMETRY["second"]
TOL = {"rtol": 1e-4, "atol": 1e-4}


def pvrcnn_model_cfg():
    cfg = second_model_cfg()
    cfg["NAME"] = "PVRCNN"
    cfg["PFE"] = {
        "NAME": "VoxelSetAbstraction",
        "NUM_KEYPOINTS": 64,
        "NUM_OUTPUT_FEATURES": 32,
        "FEATURES_SOURCE": ["bev", "x_conv1", "x_conv3", "raw_points"],
        "SA_LAYER": {
            "raw_points": {"MLPS": [[8, 8]], "POOL_RADIUS": [1.2], "NSAMPLE": [8]},
            "x_conv1": {"MLPS": [[8, 8]], "POOL_RADIUS": [0.8], "NSAMPLE": [8]},
            "x_conv3": {"MLPS": [[8, 8]], "POOL_RADIUS": [2.4], "NSAMPLE": [8]},
        },
    }
    cfg["POINT_HEAD"] = {
        "NAME": "PointHeadSimple", "CLS_FC": [16], "CLASS_AGNOSTIC": True,
        "USE_POINT_FEATURES_BEFORE_FUSION": True,
        "LOSS_CONFIG": {"LOSS_WEIGHTS": {"point_cls_weight": 1.0}},
    }
    cfg["ROI_HEAD"] = {
        "NAME": "PVRCNNHead", "CLASS_AGNOSTIC": True,
        "SHARED_FC": [32], "CLS_FC": [16], "REG_FC": [16], "DP_RATIO": 0.0,
        "NMS_CONFIG": {
            "TRAIN": {"NMS_TYPE": "nms_gpu", "MULTI_CLASSES_NMS": False,
                      "NMS_PRE_MAXSIZE": 128, "NMS_POST_MAXSIZE": 32, "NMS_THRESH": 0.8},
            "TEST": {"NMS_TYPE": "nms_gpu", "MULTI_CLASSES_NMS": False,
                     "NMS_PRE_MAXSIZE": 128, "NMS_POST_MAXSIZE": 16, "NMS_THRESH": 0.7},
        },
        "ROI_GRID_POOL": {"GRID_SIZE": 3, "MLPS": [[8, 8]], "POOL_RADIUS": [0.8],
                          "NSAMPLE": [8], "POOL_METHOD": "max_pool"},
        "TARGET_CONFIG": {
            "BOX_CODER": "ResidualCoder", "ROI_PER_IMAGE": 16, "FG_RATIO": 0.5,
            "SAMPLE_ROI_BY_EACH_CLASS": True, "CLS_SCORE_TYPE": "roi_iou",
            "CLS_FG_THRESH": 0.75, "CLS_BG_THRESH": 0.25, "CLS_BG_THRESH_LO": 0.1,
            "HARD_BG_RATIO": 0.8, "REG_FG_THRESH": 0.55,
        },
        "LOSS_CONFIG": {
            "CLS_LOSS": "BinaryCrossEntropy", "REG_LOSS": "smooth-l1",
            "CORNER_LOSS_REGULARIZATION": True,
            "LOSS_WEIGHTS": {"rcnn_cls_weight": 1.0, "rcnn_reg_weight": 1.0,
                             "rcnn_corner_weight": 1.0, "code_weights": [1.0] * 7},
        },
    }
    return cfg


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    """JAX's tiny PV-RCNN: init, and one train forward + loss (its sampler
    key recorded)."""
    cfg_dict = pvrcnn_model_cfg()
    jcfg = JConfig(cfg_dict)
    jmodel = jpv.PVRCNN(model_cfg=jcfg, num_class=1, point_cloud_range=PCR, voxel_size=VS,
                        grid_size=GS)
    pts, gt = toy_batch(0, GT_XY)
    jp, jg = jnp.asarray(pts), jnp.asarray(gt)
    rngs = {"params": jax.random.PRNGKey(0), "sampler": jax.random.PRNGKey(1)}
    variables = jax.jit(lambda p, g: jmodel.init(rngs, p, g, train=True,
                                                 max_voxels=MAX_VOXELS))(jp, jg)
    params, stats0 = variables["params"], variables["batch_stats"]
    keys = []
    sample = jpv.sample_rois_for_rcnn

    def recording(key, *args):
        keys.append(key)
        return sample(key, *args)

    def train(p, s, points, gt_boxes):
        out, mut = jmodel.apply({"params": p, "batch_stats": s}, points, gt_boxes, train=True,
                                max_voxels=MAX_VOXELS, rngs={"sampler": jax.random.PRNGKey(2)},
                                mutable=["batch_stats"])
        loss, metrics = jpv.pvrcnn_loss(out, gt_boxes, jcfg)
        return out, mut["batch_stats"], metrics, keys[-1]

    jpv.sample_rois_for_rcnn = recording
    try:
        out, stats1, metrics, key = jax.jit(train)(params, stats0, jp, jg)
    finally:
        jpv.sample_rois_for_rcnn = sample
    port = build_network(Config(cfg_dict), 1, device="cpu", dataset=geometry("second"))
    shapes = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    return types.SimpleNamespace(
        cfg=Config(cfg_dict), jcfg=jcfg, jmodel=jmodel, port=port, pts=pts, gt=gt,
        shapes=shapes, params=params, stats0=stats0, stats1=stats1, key=key, out=_np(out),
        metrics={k: float(v) for k, v in metrics.items()})


@pytest.fixture(scope="module")
def jax_eval(pair):
    """JAX's eval forward with the train forward's statistics."""
    return _np(jax.jit(lambda v, p: pair.jmodel.apply(v, p, train=False,
                                                      max_voxels=MAX_VOXELS))(
        {"params": pair.params, "batch_stats": pair.stats1}, jnp.asarray(pair.pts)))


def _load(pair, stats):
    pair.port.load_state_dict(pvrcnn_state_dict_from_jax(pair.params, stats, pair.jcfg))


# --- the pieces ------------------------------------------------------------------


def test_bilinear_bev_matches_jax():
    """NCHW in the port, NHWC in JAX; points inside, on and past the map's
    edges."""
    rng = np.random.RandomState(0)
    bev = rng.randn(2, 6, 5, 7).astype(np.float32)  # (B, C, H, W)
    xy = rng.uniform(-1.0, 16.0, (2, 40, 2)).astype(np.float32)
    xy[0, :4] = [[0.0, -8.0], [3.5, 0.0], [13.5, 7.5], [14.0, 8.5]]
    pcr, vs = (0.0, -8.0, -3.0), (0.5, 0.5, 0.125)
    got = pv.bilinear_bev(torch.from_numpy(bev), torch.from_numpy(xy), pcr, vs, 4)
    want = jpv.bilinear_bev(jnp.asarray(bev.transpose(0, 2, 3, 1)), jnp.asarray(xy), pcr, vs, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_voxel_centers_and_roi_grid_points_match_jax():
    rng = np.random.RandomState(1)
    coords = rng.randint(0, 30, (2, 50, 3)).astype(np.int64)
    for stride in (1, 2, 4, 8):
        got = pv.voxel_centers(torch.from_numpy(coords), stride, PCR, VS)
        want = jpv.voxel_centers(jnp.asarray(coords.astype(np.int32)), stride, PCR, VS)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    rois = np.concatenate([rng.uniform(-5, 5, (2, 7, 3)), rng.uniform(0.5, 4, (2, 7, 3)),
                           rng.uniform(-np.pi, np.pi, (2, 7, 1))], -1).astype(np.float32)
    for g in (1, 3, 6):
        got = pv.roi_grid_points(torch.from_numpy(rois), g)
        want = jpv.roi_grid_points(jnp.asarray(rois), g)
        assert got.shape == (2, 7, g ** 3, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("nsample", [4, 16])
def test_query_and_group_masked_matches_jax(nsample):
    """Indices equal and grouped values within 1e-5, with masked sources
    parked at 1e6 (as PV-RCNN parks its padded voxels), empty balls and
    balls holding fewer points than ``nsample``."""
    rng = np.random.RandomState(2)
    xyz = rng.uniform(-4, 4, (2, 300, 3)).astype(np.float32)
    mask = rng.uniform(size=(2, 300)) < 0.7
    xyz = np.where(mask[..., None], xyz, 1e6).astype(np.float32)
    feats = rng.randn(2, 300, 5).astype(np.float32)
    centres = rng.uniform(-6, 6, (2, 60, 3)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (xyz, mask, centres)]
    idx, empty = stack.ball_query_masked(t[0], t[1], t[2], 1.0, nsample)
    jidx, jempty = jstack.ball_query_masked(jnp.asarray(xyz), jnp.asarray(mask),
                                            jnp.asarray(centres), 1.0, nsample)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(empty.numpy(), np.asarray(jempty))
    assert empty.any() and not empty.all()
    got, _ = stack.query_and_group_masked(t[0], t[1], torch.from_numpy(feats), t[2], 1.0,
                                          nsample)
    want, _ = jstack.query_and_group_masked(jnp.asarray(xyz), jnp.asarray(mask),
                                            jnp.asarray(feats), jnp.asarray(centres), 1.0,
                                            nsample)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_plain_fps_past_32768_points_matches_jax():
    """The plain twin at N = 40000 (the cluster kernel's P = 16 range) and
    with duplicate points, index for index with JAX's XLA loop."""
    rng = np.random.RandomState(3)
    xyz = rng.uniform(-40, 40, (2, 40000, 3)).astype(np.float32)
    xyz[1, 20000:] = xyz[1, :20000]  # point j + 20000 repeats point j
    got = furthest_point_sample_plain(torch.from_numpy(xyz), 48)
    want = np.asarray(_furthest_point_sample_xla(jnp.asarray(xyz), 48))
    np.testing.assert_array_equal(got.numpy(), want)


def test_multiscale_backbone_matches_jax(pair):
    """x_conv1..x_conv4 of the sparse backbone with the model's weights:
    coords, keys and validity equal, features within 1e-4."""
    jbb = jsc.VoxelBackBone8x(return_multiscale=True)
    pts = jnp.asarray(pair.pts)
    shape = (GS[2] + 1, GS[1], GS[0])

    def prep(p):
        from modest_tpu.models.voxelize import point_voxel_coords as jpvc
        from modest_tpu.models.voxelize import voxelize_sparse as jvs

        c, v = jpvc(p, PCR, VS, GS)
        return jvs(p, v, c, MAX_VOXELS, *GS)

    vc, vf, vv, vk = jax.vmap(prep)(pts)
    _, want = jax.jit(lambda v, *a: jbb.apply(v, *a, shape))(
        {"params": pair.params["backbone_3d"], "batch_stats": pair.stats0["backbone_3d"]},
        vf, vc, vk, vv)
    _load(pair, pair.stats0)
    port = pair.port.eval()
    points = torch.from_numpy(pair.pts)
    coords, valid = point_voxel_coords(points, port.point_cloud_range, port.voxel_size, GS)
    pc, pf, pvv, pk = voxelize_sparse(points, valid, coords, MAX_VOXELS, *GS)
    with torch.no_grad():
        _, got = port.backbone_3d(pf, pc, pk, pvv, shape)
    assert list(got) == ["x_conv1", "x_conv2", "x_conv3", "x_conv4"]
    for name, (f, c, v, k) in got.items():
        jf, jc, jv, jk = (np.asarray(a) for a in want[name])
        np.testing.assert_array_equal(v.numpy(), jv, err_msg=name)
        np.testing.assert_array_equal(c.numpy()[v.numpy()], jc[jv], err_msg=name)
        np.testing.assert_array_equal(k.numpy()[v.numpy()], jk[jv], err_msg=name)
        np.testing.assert_allclose(f.numpy(), jf, rtol=1e-4, atol=1e-4, err_msg=name)
        assert v.sum() > 0


def test_vsa_source_forward_and_gradient_match_jax():
    """One two-radius VSA source on masked voxel centres: the forward in
    train mode and the gradient of a weighted sum with respect to the
    features and every weight, within 1e-4 of JAX's (``jax.grad`` of the
    source alone)."""
    rng = np.random.RandomState(4)
    xyz = rng.uniform(-3, 3, (2, 200, 3)).astype(np.float32)
    mask = rng.uniform(size=(2, 200)) < 0.8
    xyz = np.where(mask[..., None], xyz, 1e6).astype(np.float32)
    feats = rng.randn(2, 200, 6).astype(np.float32)
    centres = rng.uniform(-3, 3, (2, 30, 3)).astype(np.float32)
    weights = rng.randn(2, 30, 12).astype(np.float32)
    jsrc = jpv.VSASource(radii=(0.8, 1.6), nsamples=(8, 16), mlps=((8, 8), (4, 4)))
    args = [jnp.asarray(a) for a in (xyz, mask, feats, centres)]
    variables = jsrc.init(jax.random.PRNGKey(5), *args)

    def loss(params, f):
        out, _ = jsrc.apply({"params": params, "batch_stats": variables["batch_stats"]},
                            args[0], args[1], f, args[3], train=True, mutable=["batch_stats"])
        return (out * weights).sum(), out

    (_, jout), (gparams, gfeats) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                              has_aux=True))(
        variables["params"], args[2])
    src = pv.VSASource(6, (0.8, 1.6), (8, 16), ((8, 8), (4, 4)))
    params, stats = _np(variables["params"]), _np(variables["batch_stats"])
    for i in range(2):
        src[i].load_state_dict(mlp_state_from_jax(params[f"SharedMLP_{i}"],
                                                  stats[f"SharedMLP_{i}"]))
    src.train()
    f = torch.from_numpy(feats).requires_grad_(True)
    out = src(torch.from_numpy(xyz), torch.from_numpy(mask), f, torch.from_numpy(centres))
    (out * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(gfeats), **TOL)
    gparams = _np(gparams)
    for i in range(2):
        want = mlp_state_from_jax(gparams[f"SharedMLP_{i}"], stats[f"SharedMLP_{i}"])
        for name, p in src[i].named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), **TOL,
                                       err_msg=f"{i}.{name}")


# --- the whole model ---------------------------------------------------------------


def test_bridge_covers_every_leaf(pair):
    sd = pvrcnn_state_dict_from_jax(pair.params, pair.stats0, pair.jcfg)
    assert set(sd) == set(pair.shapes)
    for k, v in sd.items():
        assert tuple(v.shape) == pair.shapes[k], k
    leaves = jax.tree_util.tree_leaves((pair.params, pair.stats0))
    n_port = sum(v.numel() for k, v in sd.items() if not k.endswith("num_batches_tracked"))
    assert n_port == sum(np.asarray(v).size for v in leaves)


def test_eval_forward_and_boxes_match_jax(pair, jax_eval):
    """Keypoints equal, the RCNN outputs within 1e-4 abs + 1e-4 rel, the
    final boxes 1:1 with the post-processing of JAX's outputs."""
    _load(pair, pair.stats1)
    model_cfg = pair.cfg
    points = torch.from_numpy(pair.pts)
    pair.port.eval()
    with torch.inference_mode():
        out = pair.port(points, max_voxels=MAX_VOXELS)
    final = api.post_process(out, model_cfg)
    want = jax_eval
    np.testing.assert_array_equal(out["keypoints"].numpy(), want["keypoints"])
    np.testing.assert_array_equal(out["roi_valid"].numpy(), want["roi_valid"])
    for key in ("rois", "rcnn_cls", "rcnn_reg", "pkw_logits", "batch_cls_preds",
                "batch_box_preds"):
        np.testing.assert_allclose(out[key].numpy(), want[key], **TOL, err_msg=key)
    ref = api.post_process({k: torch.from_numpy(np.array(want[k])) for k in
                            ("batch_cls_preds", "batch_box_preds", "roi_valid", "roi_labels",
                             "rois")}, model_cfg)
    for i in range(len(pair.pts)):
        v, jv = final["valid"][i].numpy(), ref["valid"][i].numpy()
        assert v.sum() == jv.sum() > 0
        np.testing.assert_allclose(final["boxes"][i].numpy()[v], ref["boxes"][i].numpy()[jv],
                                   **TOL)
        np.testing.assert_allclose(final["scores"][i].numpy()[v], ref["scores"][i].numpy()[jv],
                                   **TOL)


def test_train_forward_and_loss_match_jax(pair):
    """The train forward with JAX's sampler draws: anchor labels and the
    sampled RoIs equal, every pvrcnn_loss term within rtol 1e-4, and the
    running statistics it leaves behind."""
    from modest_tpu_torch.train.state import step_roi_draws

    _load(pair, pair.stats0)
    model_cfg = pair.cfg
    tcfg = model_cfg.ROI_HEAD
    draws = jax_draws(pair.key, 2, int(tcfg.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE),
                      int(tcfg.TARGET_CONFIG.ROI_PER_IMAGE))
    assert {k: v.shape for k, v in step_roi_draws(model_cfg, 2, 0, 666, "cpu").items()} == {
        k: v.shape for k, v in draws.items()}
    gt = torch.from_numpy(pair.gt)
    pair.port.train()
    out = pair.port(torch.from_numpy(pair.pts), gt, roi_draws=draws, max_voxels=MAX_VOXELS)
    loss, metrics = api.compute_loss(out, gt, model_cfg, 1)
    np.testing.assert_array_equal(out["box_cls_labels"].numpy(), pair.out["box_cls_labels"])
    for key in ("rois", "gt_of_rois", "rcnn_cls_labels", "reg_valid_mask"):
        np.testing.assert_allclose(out["roi_targets"][key].numpy(),
                                   pair.out["roi_targets"][key], **TOL, err_msg=key)
    assert set(metrics) == set(pair.metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(v.item(), pair.metrics[k], rtol=1e-4, err_msg=k)
    # the random stage 1 proposes no RoI above REG_FG_THRESH: the shared
    # roi_head_loss's regression is held to JAX's in tests/test_torch_losses.py
    assert pair.metrics["pkw_loss"] > 0 and pair.metrics["rcnn_loss_cls"] > 0
    loss.backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in pair.port.parameters())
    stats = pvrcnn_state_dict_from_jax(pair.params, pair.stats1, pair.jcfg)
    own = pair.port.state_dict()
    checked = 0
    for k, v in stats.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(own[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)
            checked += 1
    assert checked >= 20
    pair.port.eval()


def test_build_network_routes_pvrcnn():
    """The data geometry is required; the model is a grid detector with the
    keypoint head; an unported sparse backbone is refused."""
    cfg = Config(pvrcnn_model_cfg())
    with pytest.raises(ValueError, match="geometry"):
        build_network(cfg, 1, device="cpu")
    model = build_network(cfg, 1, device="cpu", dataset=geometry("second"))
    assert isinstance(model, pv.PVRCNN) and model.backbone_3d.return_multiscale
    assert list(model.vsa) == ["x_conv1", "x_conv3", "raw_points"]
    bad = copy.deepcopy(pvrcnn_model_cfg())
    bad["BACKBONE_3D"] = {"NAME": "VoxelResBackBone8x"}
    with pytest.raises(NotImplementedError):
        build_network(Config(bad), 1, device="cpu", dataset=geometry("second"))


@pytest.mark.parametrize("section", ["CLASS_NAMES", "DATA_CONFIG", "MODEL", "OPTIMIZATION"])
def test_pv_rcnn_dicts_equal_the_jax_loaders_yaml(section):
    """configs.py ships pv_rcnn_dynamic_obj.yaml whole, as
    modest_tpu.utils.config reads it."""
    import json

    from modest_tpu.utils.config import cfg_from_yaml_file
    from modest_tpu_torch import configs

    yaml = "configs/models/lyft_models/pv_rcnn_dynamic_obj.yaml"
    want = cfg_from_yaml_file(yaml).to_dict()
    full = configs.PV_RCNN_DYNAMIC_OBJ_FULL
    assert list(want) == list(full)
    assert json.dumps(full[section]) == json.dumps(want[section])
    assert configs.SHIPPED_MODEL_CONFIGS[yaml] is full


# --- the CLIs ---------------------------------------------------------------------


def tiny_full_config(data_path):
    """The Lyft PV-RCNN file with the tiny model, 512 points a scan and a
    32 x 32 x 32 voxel grid on its range."""
    from modest_tpu_torch.configs import PV_RCNN_DYNAMIC_OBJ_FULL

    full = Config(copy.deepcopy(PV_RCNN_DYNAMIC_OBJ_FULL))
    full.DATA_CONFIG.DATA_PATH = str(data_path)
    full.DATA_CONFIG.DATA_PROCESSOR[1].NUM_POINTS = {"train": 512, "test": 512}
    full.DATA_CONFIG.DATA_PROCESSOR[3].VOXEL_SIZE = [2.825, 2.5, 0.125]
    full.MODEL = pvrcnn_model_cfg()
    full.OPTIMIZATION.LR = 0.002
    return full


def _write_yaml(full, path):
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(full.to_dict(), f)
    return path


def test_train_and_test_clis(tmp_path):
    """cli/train.py (2 steps at B = 2, every PV-RCNN loss finite, then the
    eval after training) and cli/test.py on its checkpoint (every val frame
    once, the RoI recall counted). The resume is the loop's, held for the
    grid detectors in tests/test_torch_grid_cli.py."""
    from modest_tpu_torch.cli import test as test_cli
    from modest_tpu_torch.cli import train as train_cli
    from modest_tpu_torch.data.kitti_dataset import create_kitti_infos
    from tests import synth_kitti

    synth_kitti.make_dataset(tmp_path, n_train=4, n_val=2, seed=3)
    full = tiny_full_config(tmp_path)
    create_kitti_infos(full.DATA_CONFIG, ["Dynamic"], tmp_path, tmp_path)
    cfg_file = _write_yaml(full, tmp_path / "tiny_pv_rcnn.yaml")
    out = tmp_path / "out"
    state = train_cli.main(["--cfg_file", str(cfg_file), "--batch_size", "2", "--epochs", "1",
                            "--fix_random_seed", "--device", "cpu", "--output_dir", str(out),
                            "--eval_after_train"])
    assert [r["step"] for r in state.history] == [0, 1]
    for rec in state.history:
        assert set(rec["metrics"]) == {"rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir",
                                       "pkw_loss", "rcnn_loss_cls", "rcnn_loss_reg", "loss",
                                       "grad_norm"}
        assert all(np.isfinite(v) for v in rec["metrics"].values())
    assert (out / "eval" / "epoch_1" / "val" / "result.pkl").exists()
    det_annos, results = test_cli.main(["--cfg_file", str(cfg_file), "--ckpt_dir",
                                        str(out / "ckpt"), "--batch_size", "2", "--workers",
                                        "0", "--device", "cpu", "--output_dir",
                                        str(tmp_path / "eval")])
    assert sorted(a["frame_id"] for a in det_annos) == ["000004", "000005"]
    assert all(np.isfinite(a["boxes_lidar"]).all() for a in det_annos)
    assert "roi_0.3" in results["recall"]


def test_self_train_round(seeded, tmp_path):  # noqa: F811
    """One round of cli/self_train.py with the tiny PV-RCNN on the
    three-traversal world of tests/test_torch_self_train.py: the round
    trained, the train split inferred (every frame once)."""
    import pickle

    from modest_tpu_torch.cli import self_train
    from modest_tpu_torch.train.checkpoint import CheckpointManager

    root, _ = seeded
    cfg_file = _write_yaml(tiny_full_config(root), tmp_path / "tiny_pv_rcnn.yaml")
    out_root = tmp_path / "st_out"
    timings = self_train.main([
        "--cfg_file", str(cfg_file), "--base_data", str(root), "--work_dir", str(root),
        "--seed_result", str(root / "seed_result.pkl"), "--max_iter", "1",
        "--output_root", str(out_root), "--rounds_dir", str(out_root / "rounds"),
        "--batch_size", "1", "--epochs", "1", "--num_devices", "1", "--device", "cpu"])
    assert list(timings) == ["round_1"]
    with open(out_root / "round_1" / "eval_train" / "result.pkl", "rb") as f:
        annos = pickle.load(f)
    assert [a["frame_id"] for a in annos] == ["000000", "000001", "000002"]
    assert CheckpointManager(out_root / "round_1" / "ckpt").epochs() == [1]
