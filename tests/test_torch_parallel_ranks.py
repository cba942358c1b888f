"""Two processes of the port in one gloo process group on the CPU against the
same work done by one process on the global batch (and, for the batch norms,
by flax and the JAX package on the global batch).

One spawn of WORLD processes (``run_ranks``; each one thread, a 60 s
process-group timeout, the whole spawn bounded by TIMEOUT_S) computes, each
process on its rows of a global batch:

* the batch norms: ``BatchNorm`` and ``BatchNorm2d`` against flax's
  ``nn.BatchNorm``, ``MaskedBatchNorm`` against the JAX package's, on the
  global batch: outputs, running statistics, the input gradient and the
  summed weight gradients within rtol 1e-5;
* two train steps (``train/state.py::train_step``, the flagship's one-cycle
  Adam) of the tiny PointRCNN and the tiny SECOND: every parameter and
  batch-norm buffer within 1e-5 of its norm of the one-process steps on the
  concatenated batch, the logged losses and gradient norm within rtol 1e-5,
  and the processes equal to each other bit for bit. The steps run in
  float64: Adam's first steps move each parameter by about ±lr whatever the
  size of its gradient, so in float32 the two summation orders' rounding
  (~3e-6 of a gradient's norm) flips the sign of near-zero gradient entries
  and parts the parameters by up to 2·lr there, which says nothing of the
  distributed step;
* ``train/loop.py::eval_one_epoch`` of the tiny PointRCNN on a five-frame
  split at a global batch of 4 (one process's shard wrap-padded): rank 0
  returns every frame once, in order, with the detections (boxes within
  1e-4) and recall counts of one process evaluating each shard's batches,
  the other rank (None, {}).

This module imports no JAX at its top: the spawned processes import it.
"""
import copy
import datetime
import functools
import pickle
import time
import types

import numpy as np
import pytest
import torch

from modest_tpu_torch.configs import POINTRCNN_DYNAMIC_OBJ_FULL
from modest_tpu_torch.data.kitti_dataset import create_kitti_infos
from modest_tpu_torch.data.loader import build_dataloader
from modest_tpu_torch.models import build_network
from modest_tpu_torch.models.layers import BatchNorm, BatchNorm2d, MaskedBatchNorm
from modest_tpu_torch.parallel.mesh import reduce_gradients
from modest_tpu_torch.parallel.multihost import free_port, shutdown, start_process_group
from modest_tpu_torch.tools.synth_kitti import make_dataset
from modest_tpu_torch.train.loop import eval_one_epoch
from modest_tpu_torch.train.state import create_train_state, train_step
from modest_tpu_torch.utils.config import Config

WORLD = 2
TIMEOUT_S = 150
GLOBAL_B = 4
MAX_VOXELS = 512


def _rank(rank, world, port, fn, args, outdir):
    torch.set_num_threads(1)
    start_process_group(f"127.0.0.1:{port}", world, rank, "cpu",
                        timeout=datetime.timedelta(seconds=60))
    try:
        out = fn(rank, world, *args)
    finally:
        shutdown()
    with open(outdir / f"rank_{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def run_ranks(fn, args, outdir, world=WORLD, meanwhile=lambda: None):
    """``fn(rank, world, *args)`` in ``world`` spawned processes of one gloo
    group, and ``meanwhile()`` here while they run; (their results in rank
    order, what ``meanwhile`` returned). Fails when a process fails or the
    processes have not all ended within TIMEOUT_S."""
    ctx = torch.multiprocessing.start_processes(
        _rank, args=(world, free_port(), fn, args, outdir), nprocs=world, join=False,
        start_method="spawn")
    deadline = time.time() + TIMEOUT_S
    here = meanwhile()
    while not ctx.join(timeout=1.0):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the {world} processes did not end within {TIMEOUT_S} s")
    out = []
    for r in range(world):
        with open(outdir / f"rank_{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out, here


# ---- the work, on each process (rows: the process's rows of the global batch)

def _rows(x, rank, world):
    b = x.shape[0] // world
    return x[rank * b:(rank + 1) * b]


def _bn_case(bn, x, g, mask=None):
    """Forward in train mode, Σ y·g backward: y, dL/dx, the parameters'
    gradients (summed over the processes) and the running statistics."""
    x = torch.from_numpy(x).requires_grad_(True)
    y = bn(x) if mask is None else bn(x, torch.from_numpy(mask))
    (y * torch.from_numpy(g)).sum().backward()
    reduce_gradients(bn.parameters())
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(), "dw": bn.weight.grad.numpy(),
            "db": bn.bias.grad.numpy(), "mean": bn.running_mean.numpy(),
            "var": bn.running_var.numpy()}


def _bn_norms(rank, world, inputs):
    out = {}
    for name, (x, g, mask, scale, bias) in inputs.items():
        c = scale.shape[0]
        bn = {"bn1d": lambda: BatchNorm(c, eps=1e-5, momentum=0.1),
              "bn2d": lambda: BatchNorm2d(c), "masked": lambda: MaskedBatchNorm(c)}[name]()
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(scale))
            bn.bias.copy_(torch.from_numpy(bias))
        out[name] = _bn_case(bn.train(), _rows(x, rank, world), _rows(g, rank, world),
                             None if mask is None else _rows(mask, rank, world))
    return out


def train_two_steps(rank, world, model_cfg, opt_cfg, geometry, batches):
    """Two float64 steps of ``train_step`` from the seed-0 weights on this
    process's rows of each global batch (all of it in one process); the
    state dict after them and the metrics."""
    model = build_network(Config(model_cfg), 1, device="cpu", dataset=geometry, seed=0).double()
    if geometry is not None:  # SECOND at the voxel cap of its JAX tests (no scan has more)
        model.forward = functools.partial(model.forward, max_voxels=MAX_VOXELS)
    state = create_train_state(model, Config(opt_cfg), total_steps=10)
    metrics = []
    for points, gt in batches:
        m = train_step(state, Config(model_cfg),
                       torch.from_numpy(_rows(points, rank, world)).double(),
                       torch.from_numpy(_rows(gt, rank, world)).double())
        metrics.append({k: float(v.detach()) for k, v in m.items()})
    return {k: v.clone() for k, v in model.state_dict().items()}, metrics


def evaluate(full_cfg, result_dir, shard=None):
    """``eval_one_epoch`` of the seed-0 tiny model on the val split at a
    global batch of GLOBAL_B (sharded by ``build_dataloader`` in a group), or
    in one process on ``shard`` (process_id, num_processes) of it."""
    cfg = Config(full_cfg)
    b = GLOBAL_B if shard is None else GLOBAL_B // shard[1]
    dataset, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, b, training=False)
    if shard is not None:  # a shard's annos alone: no AP against the whole split
        loader.process_shard = shard
        dataset.evaluation = lambda annos, names: (None, {})
    model = build_network(cfg.MODEL, 1, device="cpu", dataset=dataset, seed=0)
    return eval_one_epoch(model, cfg.MODEL, loader, dataset, cfg.CLASS_NAMES, device="cpu",
                          result_dir=result_dir)


def _all_work(rank, world, bn_inputs, trains, full_cfg, result_dir):
    return {"bn": _bn_norms(rank, world, bn_inputs),
            "train": {name: train_two_steps(rank, world, *args) for name, args in trains.items()},
            "eval": evaluate(full_cfg, result_dir)}


# ---- the parent: inputs, the spawn, and the references

def _bn_inputs():
    rng = np.random.RandomState(11)

    def case(shape, c, masked=False):
        x = rng.normal(0.7, 2.0, shape).astype(np.float32)
        g = rng.normal(size=shape).astype(np.float32)
        mask = (rng.uniform(size=shape[:-1]) < 0.6) if masked else None
        return (x, g, mask, rng.uniform(0.5, 1.5, c).astype(np.float32),
                rng.normal(size=c).astype(np.float32))

    return {"bn1d": case((GLOBAL_B * 24, 6), 6), "bn2d": case((GLOBAL_B, 5, 7, 9), 5),
            "masked": case((GLOBAL_B, 40, 8), 8, masked=True)}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The tiny PointRCNN's data (a synthetic set of 8 train and 5 val
    frames), two global train batches of each model, and the processes'
    results."""
    from test_pointrcnn_model import tiny_model_cfg
    from test_torch_grid_detectors import GEOMETRY, PCR, second_model_cfg, toy_batch

    root = tmp_path_factory.mktemp("parallel_ranks")
    make_dataset(root, n_train=8, n_val=5, seed=21)
    full = Config(copy.deepcopy(POINTRCNN_DYNAMIC_OBJ_FULL))
    full.DATA_CONFIG.DATA_PATH = str(root)
    full.DATA_CONFIG.DATA_PROCESSOR[1].NUM_POINTS = {"train": 512, "test": 512}
    create_kitti_infos(full.DATA_CONFIG, ["Dynamic"], root, root)
    full.MODEL = tiny_model_cfg()
    full.OPTIMIZATION.LR = 0.002
    full = full.to_dict()

    np.random.seed(666)
    _, loader = build_dataloader(Config(full).DATA_CONFIG, ["Dynamic"], GLOBAL_B, training=True)
    rcnn_batches = [(b["points"], b["gt_boxes"]) for b in loader]
    vs, gs, gt_xy = GEOMETRY["second"]
    grid = types.SimpleNamespace(point_cloud_range=np.asarray(PCR, np.float32), voxel_size=vs,
                                 grid_size=np.asarray(gs))
    second_batches = [toy_batch(seed, gt_xy, b=GLOBAL_B) for seed in (0, 1)]
    trains = {"pointrcnn": (full["MODEL"], full["OPTIMIZATION"], None, rcnn_batches),
              "second": (second_model_cfg(), full["OPTIMIZATION"], grid, second_batches)}
    bn_inputs = _bn_inputs()

    def one_process():
        """The references, computed while the processes run, on one thread as
        each of them (the host's other cores are theirs and other tests')."""
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return ({name: train_two_steps(0, 1, *args) for name, args in trains.items()},
                    [evaluate(full, root / f"eval_shard_{pid}", shard=(pid, WORLD))
                     for pid in range(WORLD)])
        finally:
            torch.set_num_threads(threads)

    (root / "ranks").mkdir()
    results, (steps, shards) = run_ranks(
        _all_work, (bn_inputs, trains, full, root / "eval_ranks"), root / "ranks",
        meanwhile=one_process)
    return types.SimpleNamespace(root=root, full=full, trains=trains, bn_inputs=bn_inputs,
                                 results=results, steps=steps, shards=shards)


def _flax_reference(name, x, g, mask, scale, bias):
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from modest_tpu.models.layers import MaskedBatchNorm as JMaskedBatchNorm

    if name == "masked":
        module, kw = JMaskedBatchNorm(), {"train": True}
        args = (jnp.asarray(mask),)
        stats = {"mean": jnp.zeros_like(scale), "var": jnp.ones_like(scale)}
        xin = x
    else:
        momentum, eps = (0.9, 1e-5) if name == "bn1d" else (0.99, 1e-3)
        module, kw, args = nn.BatchNorm(use_running_average=False, momentum=momentum,
                                        epsilon=eps), {}, ()
        stats = {"mean": jnp.zeros_like(scale), "var": jnp.ones_like(scale)}
        # flax normalizes the last axis: the port's (B, C, H, W) as (B, H, W, C)
        xin = x if name == "bn1d" else x.transpose(0, 2, 3, 1)
    gin = g if name != "bn2d" else g.transpose(0, 2, 3, 1)

    def loss(p, xx):
        y, mut = module.apply({"params": p, "batch_stats": stats}, xx, *args, **kw,
                              mutable=["batch_stats"])
        return (y * gin).sum(), (y, mut["batch_stats"])

    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    (_, (y, st)), (dp, dx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(xin))
    y, dx = np.asarray(y), np.asarray(dx)
    if name == "bn2d":
        y, dx = y.transpose(0, 3, 1, 2), dx.transpose(0, 3, 1, 2)
    return {"y": y, "dx": dx, "dw": np.asarray(dp["scale"]), "db": np.asarray(dp["bias"]),
            "mean": np.asarray(st["mean"]), "var": np.asarray(st["var"])}


@pytest.mark.parametrize("name", ["bn1d", "bn2d", "masked"])
def test_batch_norms_take_the_global_batch(env, name):
    want = _flax_reference(name, *env.bn_inputs[name])
    got = [r["bn"][name] for r in env.results]
    for key in ("y", "dx"):  # each process holds its rows
        np.testing.assert_allclose(np.concatenate([g[key] for g in got]), want[key],
                                   rtol=1e-5, atol=1e-5, err_msg=f"{name} {key}")
    for key in ("dw", "db", "mean", "var"):
        for g in got:
            np.testing.assert_allclose(g[key], want[key], rtol=1e-5, atol=1e-5,
                                       err_msg=f"{name} {key}")
        np.testing.assert_array_equal(got[0][key], got[1][key])


@pytest.mark.parametrize("name", ["pointrcnn", "second"])
def test_two_process_steps_are_the_global_batch_step(env, name):
    want_sd, want_metrics = env.steps[name]
    (sd0, m0), (sd1, m1) = (r["train"][name] for r in env.results)
    assert sd0.keys() == want_sd.keys()
    for k, want in want_sd.items():
        assert torch.equal(sd0[k], sd1[k]), f"{name}: the processes differ at {k}"
        if want.dtype.is_floating_point:
            err = float((sd0[k] - want).norm())
            assert err <= 1e-5 * max(float(want.norm()), 1e-12), (name, k, err)
        else:
            assert torch.equal(sd0[k], want), (name, k)
    assert m0 == m1
    for got, want in zip(m0, want_metrics):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_two_process_eval_merges_every_frame_once(env):
    """The merged eval against one process's eval of each shard, interleaved
    (the points of a frame are sampled under its batch's seed, so a frame's
    input depends on the batch it rides in; the shards' batches are the
    processes' batches)."""
    (annos, ret), (none, empty) = (r["eval"] for r in env.results)
    assert none is None and empty == {}
    shards = env.shards
    want_annos = [a for pair in zip(shards[0][0], shards[1][0] + [None]) for a in pair if a]
    want_recall = {k: sum(r["recall"][k] for _, r in shards) for k in shards[0][1]["recall"]}
    assert [a["frame_id"] for a in annos] == [a["frame_id"] for a in want_annos] == [
        f"{i:06d}" for i in range(8, 13)]
    assert ret["recall"] == want_recall and want_recall["gt"] > 0
    assert sum(len(a["score"]) for a in annos) > 0
    for a, w in zip(annos, want_annos):
        assert len(a["score"]) == len(w["score"]), a["frame_id"]
        np.testing.assert_allclose(a["boxes_lidar"], w["boxes_lidar"], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(a["score"], w["score"], rtol=1e-4, atol=1e-5)
    assert not any((env.root / "eval_ranks" / "merge_tmp").rglob("*.pkl"))
    with open(env.root / "eval_ranks" / "result.pkl", "rb") as f:
        assert [a["frame_id"] for a in pickle.load(f)] == [a["frame_id"] for a in annos]
