"""Shared helpers of the two-stage voxel detectors' port tests
(tests/test_torch_{second_iou,voxel_rcnn,part_a2}.py): the JAX model's
variables from ``jax.eval_shape`` of its init, filled from a numpy seed
(flax's ``model.init`` of these models takes over a minute on the CPU), and
one jitted JAX train forward and one eval forward per test module (or one
of them), with the key the RoI sampler drew from recorded. No JAX gradient of a whole model
is taken."""
from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

# imported before any jit: its module constants must not be made under a trace
from modest_tpu.models import sparse_conv  # noqa: F401
from modest_tpu.models import roi_head as jroi
from modest_tpu.utils.config import Config as JConfig
from modest_tpu_torch.models import build_network
from modest_tpu_torch.utils.config import Config
from tests.test_torch_grid_detectors import GEOMETRY, PCR, geometry, toy_batch

MAX_VOXELS = 512
VS, GS, GT_XY = GEOMETRY["second"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def seeded(shapes, seed: int = 0):
    """A tree of the leaves' shapes (``jax.eval_shape`` of an init) filled from
    ``np.random.RandomState(seed)``: kernels U(±1/sqrt(fan in)), biases and
    batch-norm shifts and means small, scales near 1, variances in [0.5,
    1.5]. Returns (params, batch_stats)."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        shape = leaf.shape
        if "kernel" in name:
            fan_in = int(np.prod(shape[:-1]))
            return rng.uniform(-1, 1, shape).astype(np.float32) / np.sqrt(fan_in)
        if "scale" in name:
            return rng.uniform(0.8, 1.2, shape).astype(np.float32)
        if "var" in name:
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return rng.uniform(-0.1, 0.1, shape).astype(np.float32)

    filled = jax.tree_util.tree_map_with_path(fill, shapes)
    return filled["params"], filled["batch_stats"]


def seeded_variables(jmodel, points, gt_boxes, seed: int = 0):
    """``seeded`` variables of ``jmodel`` with the shapes its init gives."""
    return seeded(jax.eval_shape(lambda p, g: jmodel.init(
        {"params": jax.random.PRNGKey(0), "sampler": jax.random.PRNGKey(1)}, p, g, train=True,
        max_voxels=MAX_VOXELS), points, gt_boxes), seed)


def run_jax(jmodel, jcfg, loss_fn, sampler_module=None, forwards=("train", "eval")):
    """The toy batch through ``jmodel``: one jitted train forward + loss (the
    sampler's key recorded when ``sampler_module`` samples RoIs) and one
    eval forward with the statistics the train forward left, or with the
    seeded ones when ``forwards`` leaves out "train"."""
    pts, gt = toy_batch(0, GT_XY)
    jp, jg = jnp.asarray(pts), jnp.asarray(gt)
    params, stats0 = seeded_variables(jmodel, jp, jg)
    run = types.SimpleNamespace(pts=pts, gt=gt, params=_np(params), stats0=_np(stats0),
                                stats1=_np(stats0))
    if "train" in forwards:
        keys = []
        sample = jroi.sample_rois_for_rcnn

        def recording(key, *args):
            keys.append(key)
            return sample(key, *args)

        def train(p, s, points, gt_boxes):
            out, mut = jmodel.apply({"params": p, "batch_stats": s}, points, gt_boxes,
                                    train=True, max_voxels=MAX_VOXELS,
                                    rngs={"sampler": jax.random.PRNGKey(2)},
                                    mutable=["batch_stats"])
            _, metrics = loss_fn(out, gt_boxes, jcfg)
            return out, mut["batch_stats"], metrics, (keys[-1] if keys else None)

        if sampler_module is not None:
            sampler_module.sample_rois_for_rcnn = recording
        try:
            out, stats1, metrics, run.key = jax.jit(train)(params, stats0, jp, jg)
        finally:
            if sampler_module is not None:
                sampler_module.sample_rois_for_rcnn = sample
        run.out, run.stats1 = _np(out), _np(stats1)
        run.metrics = {k: float(v) for k, v in metrics.items()}
    if "eval" in forwards:
        run.eval = _np(jax.jit(lambda v, p: jmodel.apply(v, p, train=False,
                                                         max_voxels=MAX_VOXELS))(
            {"params": params, "batch_stats": run.stats1}, jp))
    return run


def port_model(cfg_dict):
    return build_network(Config(cfg_dict), 1, device="cpu", dataset=geometry("second"))


def jax_model(cls, cfg_dict):
    return cls(model_cfg=JConfig(cfg_dict), num_class=1, point_cloud_range=PCR, voxel_size=VS,
               grid_size=GS)


def bridge_covers_every_leaf(sd, port, params, stats):
    """The converted state dict has every key of the port's, at its shape, and
    as many numbers as the JAX variables, each JAX number once; loaded into
    the port it reads back unchanged."""
    shapes = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert set(sd) == set(shapes), set(sd) ^ set(shapes)
    for k, v in sd.items():
        assert tuple(v.shape) == shapes[k], k
    leaves = jax.tree_util.tree_leaves((params, stats))
    n_port = sum(v.numel() for k, v in sd.items() if not k.endswith("num_batches_tracked"))
    assert n_port == sum(np.asarray(v).size for v in leaves)
    want = np.sort(np.concatenate([np.asarray(v, np.float32).ravel() for v in leaves]))
    got = np.sort(np.concatenate([v.numpy().astype(np.float32).ravel() for k, v in sd.items()
                                  if not k.endswith("num_batches_tracked")]))
    np.testing.assert_array_equal(got, want)
    port.load_state_dict(sd)
    for k, v in port.state_dict().items():
        assert torch.equal(v, sd[k].to(v.dtype)), k
