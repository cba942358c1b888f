"""CaDDN in the PyTorch port against the JAX package on the CPU: the LID
discretisation, the frustum sample, the compact CaDDN whole at a tiny grid
(D = 8 bins, a 32 × 96 image, a 32 × 32 × 8 grid; one jitted JAX eval
forward, one train forward and loss, and the gradient in float64, the JAX
variables from ``jax.eval_shape`` of the init), its post-processing and the
depth loss with 2D boxes."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modest_tpu.models import caddn as jcd
from modest_tpu.models import grid_detectors as jgd
from modest_tpu.utils.config import Config as JConfig
from modest_tpu_torch.models import api
from modest_tpu_torch.models import caddn as cd
from modest_tpu_torch.models import build_network
from modest_tpu_torch.models.convert import caddn_state_dict_from_jax
from modest_tpu_torch.models.grid_detectors import grid_post_process
from modest_tpu_torch.utils.config import Config
from tests.torch_detector_pair import seeded
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

D_MIN, D_MAX = 2.0, 46.8
PCR = [0, -8, -3, 16, 8, 1]
VS, GS = [0.5, 0.5, 0.5], (32, 32, 8)
B, H, W = 2, 32, 96


def tiny_cfg():
    """tests/test_caddn.py's config (the compact encoder, 16 features) at D = 8."""
    from tests.test_caddn import caddn_model_cfg

    cfg = caddn_model_cfg()
    cfg.FFE.DISC_CFG.num_bins = 8
    cfg.FFE.LOSS_CONFIG.LOSS_WEIGHTS.fg_weight = 13.0
    cfg.FFE.LOSS_CONFIG.LOSS_WEIGHTS.bg_weight = 1.0
    return cfg.to_dict()


def camera_batch(seed: int = 0, b: int = B, h: int = H, w: int = W):
    """Images, a camera at the lidar origin looking down +x, depth maps at
    full resolution, 2D boxes (the second row padding) and one gt box."""
    rng = np.random.RandomState(seed)
    images = rng.rand(b, h, w, 3).astype(np.float32)
    l2c = np.array([[0.0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0], [0, 0, 0, 1]], np.float32)
    c2i = np.array([[40.0, 0, w / 2, 0], [0, 40.0, h / 2, 0], [0, 0, 1, 0]], np.float32)
    depth = rng.uniform(0, 20, (b, h, w)).astype(np.float32)
    depth[rng.rand(b, h, w) < 0.3] = 0.0
    boxes2d = np.zeros((b, 2, 4), np.float32)
    boxes2d[:, 0] = [10.0, 4.0, 50.0, 26.0]
    gt = np.zeros((b, 3, 8), np.float32)
    gt[:, 0, :7] = [16 / 3, -8 / 3, -0.75, 2, 1, 1.7, 0.0]
    gt[:, 0, 7] = 1
    return {"images": images, "trans_lidar_to_cam": np.tile(l2c, (b, 1, 1)),
            "trans_cam_to_img": np.tile(c2i, (b, 1, 1)), "depth_maps": depth,
            "gt_boxes2d": boxes2d, "gt_boxes": gt}


def test_lid_bins_exact():
    """The fractional bin and the integer target, bit for bit, at random
    depths, every bin edge and centre, and the out-of-range cases."""
    nb = 80
    delta = 2 * (D_MAX - D_MIN) / (nb * (1 + nb))
    edges = D_MIN + delta / 2 * np.arange(nb + 1) * (np.arange(nb + 1) + 1)
    rng = np.random.RandomState(0)
    depth = np.concatenate([edges, (edges[:-1] + edges[1:]) / 2, rng.uniform(-5, 60, 4000),
                            [0.0, -1.0, D_MIN, D_MAX, 100.0]]).astype(np.float32)
    for fn in ("lid_bin_from_depth", "depth_to_lid_target"):
        want = np.asarray(getattr(jcd, fn)(jnp.asarray(depth), D_MIN, D_MAX, nb))
        got = getattr(cd, fn)(torch.from_numpy(depth), D_MIN, D_MAX, nb).numpy()
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=fn)
    assert set(np.unique(got)) <= set(range(nb + 1))


def test_sample_frustum():
    """Random frustum and samples, some outside each axis and on cell
    edges, within 1e-6."""
    rng = np.random.RandomState(1)
    b, h, w, d, c, n = 2, 5, 7, 6, 3, 600
    fr = rng.randn(b, h, w, d, c).astype(np.float32)
    u = rng.uniform(-1, w, (b, n)).astype(np.float32)
    v = rng.uniform(-1, h, (b, n)).astype(np.float32)
    db = rng.uniform(-1, d, (b, n)).astype(np.float32)
    u[:, :40] = np.round(u[:, :40])
    v[:, 40:80] = np.round(v[:, 40:80])
    db[:, 80:120] = np.round(db[:, 80:120])
    want = np.asarray(jcd.sample_frustum(jnp.asarray(fr), jnp.asarray(u), jnp.asarray(v),
                                         jnp.asarray(db), h, w, d))
    got = cd.sample_frustum(torch.from_numpy(fr), *(torch.from_numpy(a) for a in (u, v, db)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert (want == 0).all(-1).sum() > 0 and (want != 0).any(-1).sum() > 0


@pytest.fixture(scope="module")
def pair():
    """The JAX and the port's tiny CaDDN on one batch: JAX's seeded
    variables, one jitted eval forward, one jitted train forward with its
    losses and new statistics, the gradient in float64; the port with the
    same weights."""
    cfg = tiny_cfg()
    jmodel = jcd.CaDDN(model_cfg=JConfig(cfg), num_class=1, point_cloud_range=PCR,
                       voxel_size=VS, grid_size=GS)
    batch = camera_batch()
    jin = [jnp.asarray(batch[k]) for k in ("images", "trans_lidar_to_cam", "trans_cam_to_img")]
    jgt = jnp.asarray(batch["gt_boxes"])
    params, stats = seeded(jax.eval_shape(lambda *a: jmodel.init(
        jax.random.PRNGKey(0), *a, train=True), *jin, jgt))
    jcfg = JConfig(cfg)

    def loss_fn(p, s, inputs, gt, boxes2d, depth):
        out, mut = jmodel.apply({"params": p, "batch_stats": s}, *inputs, gt, train=True,
                                mutable=["batch_stats"])
        out["gt_boxes2d"] = boxes2d
        loss, metrics = jcd.caddn_loss(out, gt, jcfg, depth_maps=depth)
        return loss, (metrics, mut["batch_stats"])

    extra = [jnp.asarray(batch[k]) for k in ("gt_boxes2d", "depth_maps")]
    _, (metrics, new_stats) = jax.jit(loss_fn)(params, stats, jin, jgt, *extra)
    # the gradient in float64: JAX's float32 one is 0.5-1.1 % off it at the
    # first BEV level and everything before it, the port's 3e-6 (CHANGES.md)
    with jax.enable_x64(True):
        f64 = functools.partial(jax.tree_util.tree_map,
                                lambda a: jnp.asarray(np.asarray(a, np.float64)))
        grads = jax.jit(jax.grad(lambda *a: loss_fn(*a)[0]))(
            f64(params), f64(stats), f64(jin), *f64([jgt, *extra]))
        grads = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), grads)
    jeval = jax.jit(lambda v: jmodel.apply(v, *jin, train=False))(
        {"params": params, "batch_stats": stats})
    model = build_network(Config(cfg), 1, device="cpu", dataset=type(
        "G", (), {"point_cloud_range": PCR, "voxel_size": VS, "grid_size": GS})())
    model.load_state_dict(caddn_state_dict_from_jax(params, stats, Config(cfg)))
    return {"cfg": Config(cfg), "jcfg": jcfg, "batch": batch, "model": model,
            "params": params, "stats": stats,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "new_stats": new_stats, "grads": grads,
            "eval": jax.tree_util.tree_map(np.asarray, jeval)}


def torch_inputs(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("key", ["depth_logits", "cls_preds", "box_preds", "dir_cls_preds",
                                 "batch_cls_preds", "batch_box_preds"])
def test_eval_forward(pair, key):
    inputs = torch_inputs(pair["batch"])
    out = api.apply_eval(pair["model"], pair["cfg"], inputs)
    want = pair["eval"][key]
    got = out[key].numpy()
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


def test_post_process(pair):
    """The grid detectors' NMS on JAX's decoded boxes equals JAX's
    ``grid_post_process``; JAX's ``api.post_process`` itself sends CaDDN to
    the refined-box path, which needs RoI keys CaDDN never makes."""
    from modest_tpu.models import api as japi

    ev, post_cfg = pair["eval"], pair["cfg"].POST_PROCESSING
    post_cfg.SCORE_THRESH = 0.0
    jpost = JConfig(post_cfg.to_dict())
    want = jax.tree_util.tree_map(np.asarray, jgd.grid_post_process(
        {k: jnp.asarray(ev[k]) for k in ("batch_cls_preds", "batch_box_preds")}, jpost))
    got = grid_post_process({k: torch.tensor(ev[k]) for k in ("batch_cls_preds",
                                                              "batch_box_preds")}, post_cfg)
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"])
    assert want["valid"].sum() > 0
    for key in ("boxes", "scores", "labels"):
        np.testing.assert_array_equal(got[key].numpy()[want["valid"]], want[key][want["valid"]])
    with pytest.raises(KeyError):
        japi.post_process({k: jnp.asarray(v) for k, v in ev.items()}, pair["jcfg"])


@pytest.fixture(scope="module")
def port_train(pair):
    """One port train forward, loss and backward at JAX's weights."""
    cfg, batch = pair["cfg"], pair["batch"]
    model = build_network(cfg, 1, device="cpu", dataset=type(
        "G", (), {"point_cloud_range": PCR, "voxel_size": VS, "grid_size": GS})())
    model.load_state_dict(caddn_state_dict_from_jax(pair["params"], pair["stats"], cfg))
    inputs = torch_inputs(batch)
    gt = inputs.pop("gt_boxes")
    out = api.apply_train(model, cfg, inputs, gt)
    loss, metrics = api.compute_loss(out, gt, cfg)
    loss.backward()
    return model, {k: float(v.detach()) for k, v in metrics.items()}


@pytest.mark.parametrize("key", ["rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir", "depth_loss",
                                 "loss"])
def test_train_losses(pair, port_train, key):
    _, metrics = port_train
    want = pair["metrics"][key]
    assert want > 0
    assert abs(metrics[key] - want) <= 1e-5 * abs(want), (metrics[key], want)


def test_gradients(pair, port_train):
    """Every weight's gradient within 1e-3 of the norm of JAX's (float64),
    the encoder's and the BEV collapse's among them; the encoder convs'
    biases, each before a train-mode batch norm, have a gradient of 0 up to
    rounding (norm ~1e-5), held within 1e-4."""
    model, _ = port_train
    want = caddn_state_dict_from_jax(pair["grads"], pair["stats"], pair["cfg"])
    params = dict(model.named_parameters())
    assert set(params) <= set(want)
    for name, p in params.items():
        g, w = p.grad.numpy(), want[name].numpy()
        norm = np.linalg.norm(w)
        assert norm > 0, name
        tol = 1e-4 if name.startswith("encoder.convs.") and name.endswith(".bias") \
            else 1e-3 * norm
        assert np.linalg.norm(g - w) <= tol, (name, np.linalg.norm(g - w), norm)


def test_batch_statistics(pair, port_train):
    model, _ = port_train
    want = caddn_state_dict_from_jax(pair["params"], pair["new_stats"], pair["cfg"])
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), want[name].numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("downsampled", [False, True])
def test_depth_loss_with_boxes2d(downsampled):
    """``caddn_depth_loss`` with 2D boxes (fg weight 13) on full-resolution
    depth maps (subsampled) or maps at the logits' resolution (the
    ``downsample_depth_map`` processor's block means)."""
    from modest_tpu_torch.data.processor import downsample_depth_map

    rng = np.random.RandomState(3)
    batch = camera_batch(seed=3)
    logits = rng.randn(B, H // 4, W // 4, 9).astype(np.float32) * 3
    depth = batch["depth_maps"]
    if downsampled:
        depth = np.stack([downsample_depth_map(d, 4) for d in depth])
    boxes2d = batch["gt_boxes2d"]
    boxes2d[1, 1] = [60.0, 0.0, 90.0, 12.0]
    want = float(jcd.caddn_depth_loss(jnp.asarray(logits), jnp.asarray(depth), D_MIN, 20.0, 8,
                                      gt_boxes2d=jnp.asarray(boxes2d)))
    got = float(cd.caddn_depth_loss(torch.from_numpy(logits), torch.from_numpy(depth), D_MIN,
                                    20.0, 8, gt_boxes2d=torch.from_numpy(boxes2d)))
    plain = float(cd.caddn_depth_loss(torch.from_numpy(logits), torch.from_numpy(depth), D_MIN,
                                      20.0, 8))
    assert abs(got - want) <= 1e-5 * abs(want)
    assert got != plain
