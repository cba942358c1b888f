"""One PointRCNN train step in the PyTorch port vs the JAX package (exact
mode), on the tiny config, a batch of tests/synth_kitti.py scenes (2 × 512
points) and the same weights (drawn in the JAX model's tree with batch-norm
parameters and statistics away from the identity, as tests/test_torch_slice.py
draws them, and carried over by models/convert.py), with JAX's "sampler"
draws handed to the port.

Tolerances, float32 on both sides with other summation orders: every loss
component within rtol 1e-4 (atol 1e-5), each gradient tensor within 1e-3 of
its norm, the batch-norm running statistics after the step within 1e-5 of
each tensor's norm (the unbiased variance torch's BatchNorm1d would use is
1/(n−1) larger: 3% at the RoI head's 32 rows).

Over several steps: the flagship's one-cycle Adam squeezed into 10 steps
(peak rate 0.01 at step 4) on the one batch, each side with its own
optimizer, every step's losses and gradient norm within rtol 1e-4 (atol
1e-5). JAX runs in float32 (its MLPs compute in float32 whatever the
parameters' type) and the port in float64, with FPS on a float32 copy of
the coordinates as on the card, so the port's side does not depend on its
summation order: a float32 port parts from JAX by up to 5.7 times the bound
at step 8 on one torch thread and stays within 0.1 of it on eight, while the
float64 port stays within 0.1 of it on either (9e-6 relative at most)."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import modest_tpu.models.pointrcnn as jpointrcnn
from modest_tpu.models import api as japi
from modest_tpu.ops import pointnet2 as jp2
from modest_tpu.train import optim as joptim
from modest_tpu.utils.config import Config as JConfig
from modest_tpu_torch.configs import (POINTRCNN_DYNAMIC_OBJ_DATA_CONFIG,
                                      POINTRCNN_DYNAMIC_OBJ_OPTIMIZATION)
from modest_tpu_torch.data.kitti_dataset import create_kitti_infos
from modest_tpu_torch.data.loader import build_dataloader
from modest_tpu_torch.models import build_network
from modest_tpu_torch.models.convert import state_dict_from_jax
from modest_tpu_torch.models.layers import BatchNorm
from modest_tpu_torch.models.pointrcnn import pointrcnn_loss
from modest_tpu_torch.ops import pointnet2 as tp2
from modest_tpu_torch.train.state import create_train_state, step_roi_draws, train_step
from modest_tpu_torch.utils.config import Config

import synth_kitti
from test_pointrcnn_model import tiny_model_cfg
from test_torch_losses import jax_draws
from test_torch_slice import _jax_model as jax_model
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

NUM_POINTS = 512


@pytest.fixture(scope="module", autouse=True)
def exact_ops():
    prev = jp2.exact_ops()
    jp2.set_exact_ops(True)
    yield
    jp2.set_exact_ops(prev)


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_step")
    synth_kitti.make_dataset(root, n_train=4, n_val=0, seed=3)
    cfg = copy.deepcopy(POINTRCNN_DYNAMIC_OBJ_DATA_CONFIG)
    cfg["DATA_PATH"] = str(root)
    cfg["DATA_PROCESSOR"][1]["NUM_POINTS"] = {"train": NUM_POINTS, "test": NUM_POINTS}
    create_kitti_infos(Config(cfg), ["Dynamic"], root, root, if_val=False)
    _, loader = build_dataloader(Config(cfg), ["Dynamic"], 2, training=True)
    return next(iter(loader))


SQUEEZED_STEPS = 10
STEP_METRICS = ("loss", "point_loss_cls", "point_loss_box", "rcnn_loss_cls", "rcnn_loss_reg",
                "grad_norm")


@pytest.fixture(scope="module")
def jax_steps(batch):
    """JAX's train step (train/state.py::_train_step_body with its optimizer,
    the flagship's one-cycle Adam squeezed into SQUEEZED_STEPS steps),
    jitted once and run SQUEEZED_STEPS times on the one batch from the tiny
    model's weights; each step's gradients, losses, statistics, outputs and
    the key its RoI sampler drew from (``fold_in(PRNGKey(666), step)``).
    Step 0 is the single step the other tests compare."""
    cfg = JConfig(tiny_model_cfg())
    model, params, stats = jax_model(cfg, seed=0)
    jopt = joptim.build_optimizer(JConfig(POINTRCNN_DYNAMIC_OBJ_OPTIMIZATION), SQUEEZED_STEPS)
    points, gt = jnp.asarray(batch["points"]), jnp.asarray(batch["gt_boxes"])
    keys = []
    sample = jpointrcnn.sample_rois_for_rcnn

    def recording(key, *args):
        keys.append(key)
        return sample(key, *args)

    def step_fn(params, stats, opt_state, step):
        step_rng = jax.random.fold_in(jax.random.PRNGKey(666), step)

        def loss_fn(p):
            out, new_bs = japi.apply_train(model, cfg, {"params": p, "batch_stats": stats},
                                           points, gt, step_rng)
            loss, metrics = japi.compute_loss(out, gt, cfg, num_class=1)
            return loss, (metrics, new_bs, out, keys[-1])

        grads, (metrics, new_bs, out, key) = jax.grad(loss_fn, has_aux=True)(params)
        updates, opt_state = jopt.update(grads, opt_state, params)
        record = dict(grads=grads, metrics=metrics, grad_norm=optax.global_norm(grads),
                      new_bs=new_bs, out=out, key=key)
        return optax.apply_updates(params, updates), new_bs, opt_state, record

    jpointrcnn.sample_rois_for_rcnn = recording
    try:
        step = jax.jit(step_fn)
        p, s, opt_state, records = params, stats, jopt.init(params), []
        for k in range(SQUEEZED_STEPS):
            p, s, opt_state, record = step(p, s, opt_state, k)
            records.append(record)
    finally:
        jpointrcnn.sample_rois_for_rcnn = sample
    assert len(keys) == 1
    return dict(params=params, stats=stats, steps=records)


@pytest.fixture(scope="module")
def jax_step(jax_steps):
    """JAX's step 0 before the optimizer: its gradients, losses, statistics
    and outputs, and the key its RoI sampler drew from."""
    first = jax_steps["steps"][0]
    return dict(params=jax_steps["params"], stats=jax_steps["stats"],
                **{k: first[k] for k in ("grads", "metrics", "new_bs", "out", "key")})


@pytest.fixture(scope="module")
def port_step(batch, jax_step):
    cfg = Config(tiny_model_cfg())
    model = build_network(cfg, 1, device="cpu")
    model.load_state_dict(state_dict_from_jax(jax_step["params"], jax_step["stats"]))
    rh = cfg.ROI_HEAD
    draws = jax_draws(jax_step["key"], 2, int(rh.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE),
                      int(rh.TARGET_CONFIG.ROI_PER_IMAGE))
    model.train()
    points, gt = torch.from_numpy(batch["points"]), torch.from_numpy(batch["gt_boxes"])
    out = model(points, gt, roi_draws=draws)
    loss, metrics = pointrcnn_loss(out, gt, cfg, 1)
    loss.backward()
    return dict(model=model, metrics=metrics, out=out)


def test_train_forward_samples_the_same_rois(jax_step, port_step):
    want, got = jax_step["out"], port_step["out"]
    assert got["rois"].shape == (2, 16, 7) and got["rcnn_cls"].shape == (32, 1)
    np.testing.assert_allclose(got["rois"].detach().numpy(), np.asarray(want["rois"]),
                               rtol=1e-4, atol=1e-4)
    for k in ("reg_valid_mask", "rcnn_cls_labels"):
        np.testing.assert_array_equal(got["roi_targets"][k].numpy(),
                                      np.asarray(want["roi_targets"][k]), err_msg=k)


def test_every_loss_component_equals_jax(jax_step, port_step):
    want, got = jax_step["metrics"], port_step["metrics"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert float(got["point_pos_num"]) > 10  # the synthetic cars are foreground


def test_gradients_equal_jax(jax_step, port_step):
    want = state_dict_from_jax(jax_step["grads"], jax_step["new_bs"])
    n = 0
    for name, p in port_step["model"].named_parameters():
        w = want[name].numpy()
        g = p.grad.numpy() if p.grad is not None else np.zeros_like(w)
        scale = np.linalg.norm(w)
        err = np.linalg.norm(g - w) / max(scale, 1e-12)
        assert err <= 1e-3 or scale < 1e-9, (name, err, scale)
        n += scale > 0
    assert n > 40  # gradients reach the backbone, both heads and the RoI tower


def test_batch_norm_running_stats_equal_jax(jax_step, port_step):
    want = state_dict_from_jax(jax_step["params"], jax_step["new_bs"])
    before = state_dict_from_jax(jax_step["params"], jax_step["stats"])
    got = port_step["model"].state_dict()
    checked = 0
    for name, v in got.items():
        if name.endswith(("running_mean", "running_var")):
            w = want[name].numpy()
            assert not torch.equal(v, before[name]), name  # the step moved them
            err = np.linalg.norm(v.numpy() - w) / np.linalg.norm(w)
            assert err <= 1e-5, (name, err)
            checked += 1
    assert checked == 40  # 20 batch norms of the tiny config


def test_batch_norm_trains_as_flax():
    """Biased batch variance for the output and the running statistics,
    momentum 0.9 in flax's convention; eval mode is BatchNorm1d's."""
    import flax.linen as fnn

    rng = np.random.RandomState(4)
    x = rng.normal(1.0, 2.0, (32, 6)).astype(np.float32)
    bn = BatchNorm(6)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.2, 0.2)
    fbn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": jnp.asarray(bn.weight.detach().numpy()),
                            "bias": jnp.asarray(bn.bias.detach().numpy())},
                 "batch_stats": {"mean": jnp.zeros(6), "var": jnp.ones(6)}}
    want, mut = fbn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    got = bn.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(mut["batch_stats"]["var"]),
                               rtol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]), rtol=1e-6, atol=1e-7)
    ref = torch.nn.BatchNorm1d(6)
    ref.load_state_dict(bn.state_dict())
    assert torch.equal(bn.eval()(torch.from_numpy(x)), ref.eval()(torch.from_numpy(x)))


def test_train_step_updates_and_draws_by_step(batch):
    """train/state.py: a step counts, moves the weights and returns finite
    metrics; a step's RoI draws depend only on (seed, step)."""
    cfg = Config(tiny_model_cfg())
    opt = Config({"OPTIMIZER": "adam_onecycle", "LR": 0.002, "WEIGHT_DECAY": 0.01,
                  "MOMS": [0.95, 0.85], "PCT_START": 0.4, "DIV_FACTOR": 10,
                  "GRAD_NORM_CLIP": 10})
    state = create_train_state(build_network(cfg, 1, device="cpu"), opt, total_steps=4)
    w0 = state.model.point_head.cls_layers[0].weight.detach().clone()
    metrics = train_step(state, cfg, torch.from_numpy(batch["points"]),
                         torch.from_numpy(batch["gt_boxes"]))
    assert state.step == 1 and all(np.isfinite(float(v)) for v in metrics.values())
    assert not torch.equal(state.model.point_head.cls_layers[0].weight, w0)
    a = step_roi_draws(cfg, 2, 3, 666, "cpu")
    b = step_roi_draws(cfg, 2, 3, 666, "cpu")
    c = step_roi_draws(cfg, 2, 4, 666, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a) and not torch.equal(a["u_fg"], c["u_fg"])


def test_squeezed_one_cycle_tracks_jax(batch, jax_steps, monkeypatch):
    """SQUEEZED_STEPS steps on one batch with the flagship's one-cycle Adam
    squeezed into them: JAX's step (train/state.py::_train_step_body with
    its optimizer, float32) and the port's train_step in float64, from the
    same weights, the port taking JAX's sampler draws at every step. Both
    stay finite and agree step by step (on the tests' scenes that includes
    the regression-loss spike the first foreground RoIs bring), on any
    number of torch threads."""
    fps = tp2.furthest_point_sample
    monkeypatch.setattr(tp2, "furthest_point_sample", lambda xyz, npoint: fps(xyz.float(), npoint))
    params, stats = jax_steps["params"], jax_steps["stats"]
    tcfg = Config(tiny_model_cfg())
    port = build_network(tcfg, 1, device="cpu")
    port.load_state_dict(state_dict_from_jax(params, stats))
    port.double()
    state = create_train_state(port, Config(POINTRCNN_DYNAMIC_OBJ_OPTIMIZATION), SQUEEZED_STEPS)
    tpoints = torch.from_numpy(batch["points"]).double()
    tgt = torch.from_numpy(batch["gt_boxes"]).double()
    rh = tcfg.ROI_HEAD
    rows = []
    for record in jax_steps["steps"]:
        lr = state.optimizer.current_lr()
        want = dict(record["metrics"], grad_norm=record["grad_norm"])
        draws = jax_draws(record["key"], 2, int(rh.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE),
                          int(rh.TARGET_CONFIG.ROI_PER_IMAGE))
        got = train_step(state, tcfg, tpoints, tgt,
                         roi_draws={k: v.double() for k, v in draws.items()})
        rows.append((lr, {k: float(want[k]) for k in STEP_METRICS},
                     {k: float(got[k]) for k in STEP_METRICS}))
    assert max(lr for lr, _, _ in rows) == pytest.approx(0.01, rel=1e-6)  # the peak is reached
    for s, (_, want, got) in enumerate(rows):
        assert all(np.isfinite(list(want.values()))), (s, want)
        for k in STEP_METRICS:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                       err_msg=f"step {s} {k}")
    assert all(p.dtype == torch.float64 and torch.isfinite(p).all() for p in port.parameters())
