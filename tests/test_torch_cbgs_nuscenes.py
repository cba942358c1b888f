"""The CBGS multi-head detectors fed by the nuScenes loader, on the CPU:
a narrow CBGS SECOND (``VoxelResBackBone8x``, car / truck / pedestrian in
two groups) and the tiny multi-head PointPillars of
tests/test_nuscenes_waymo.py, each trained one forward on the port
loader's training batch of a seeded full-density tree (CBGS resampling,
gt sampling, the world augmentations; gt of width 10, velocity then
class) against JAX's model on JAX's loader batch: targets, every loss and
the eval forward's multi-class NMS equal. JAX's variables come from
``jax.eval_shape`` of its init (``tests/torch_detector_pair.py``); no JAX
gradient is taken."""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from modest_tpu.data import loader as jloader
from modest_tpu.models import grid_detectors as jgd
from modest_tpu.utils.config import Config as JConfig
from modest_tpu_torch import configs
from modest_tpu_torch.data import loader as tloader
from modest_tpu_torch.models import api, build_network
from modest_tpu_torch.models.convert import grid_state_dict_from_jax
from modest_tpu_torch.tools import synth_infos
from modest_tpu_torch.utils.config import Config
from tests.test_nuscenes_waymo import TINY_MULTIHEAD
from tests.test_torch_multihead import cbgs_second_cfg
from tests.torch_detector_pair import MAX_VOXELS, run_jax

TOL = {"rtol": 1e-4, "atol": 1e-4}
NUM_POINTS = 2048
CASES = {  # model, class names, voxel size over the CBGS range
    "cbgs_second": (cbgs_second_cfg(), ["car", "truck", "pedestrian"], [0.8, 0.8, 0.2]),
    "cbgs_pillar": (TINY_MULTIHEAD, ["car", "pedestrian"], [0.8, 0.8, 8.0]),
}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("nusc")
    synth_infos.write_nuscenes_tree(root, 4, rng=np.random.RandomState(0), full_density=True,
                                    points=3000)
    np.random.seed(0)
    synth_infos.nuscenes_gt_database(root, configs.NUSCENES_DATASET_BASE,
                                     configs.CBGS_CLASS_NAMES,
                                     "nuscenes_infos_train_10sweeps_withvelo.pkl")
    return root


def data_cfg(root, conf, voxel_size):
    cfg = copy.deepcopy(configs.NUSCENES_DATASET_BASE)
    cfg.pop("VERSION")
    cfg["DATA_PATH"] = str(root)
    cfg["DATA_PROCESSOR"][2]["NUM_POINTS"] = {"train": NUM_POINTS, "test": NUM_POINTS}
    cfg["VOXEL_SIZE"] = voxel_size
    return conf(cfg)


@pytest.fixture(scope="module", params=list(CASES))
def run(request, tree):
    cfg_dict, names, vs = CASES[request.param]
    batches, sets = {}, {}
    for side, mod, conf in (("jax", jloader, JConfig), ("torch", tloader, Config)):
        np.random.seed(3)
        sets[side], loader = mod.build_dataloader(data_cfg(tree, conf, vs), names, batch_size=2,
                                                  training=True, max_gt=32)
        batches[side] = next(iter(loader))
    ds = sets["torch"]
    jcfg = JConfig(cfg_dict)
    num_class = len(names)
    jmodel = jgd.GridDetector(model_cfg=jcfg, num_class=num_class,
                              point_cloud_range=tuple(ds.point_cloud_range), voxel_size=tuple(vs),
                              grid_size=tuple(int(g) for g in ds.grid_size),
                              class_names=tuple(names))
    b = batches["jax"]
    out = run_jax(jmodel, jcfg, lambda o, g, c: jgd.grid_detector_loss(o, c, num_class),
                  batch=(b["points"], b["gt_boxes"]),
                  post=lambda o: jgd.grid_post_process(o, jcfg.POST_PROCESSING))
    out.cfg, out.num_class, out.batches = Config(cfg_dict), num_class, batches
    out.port = build_network(out.cfg, num_class, device="cpu", dataset=ds)
    return out


def test_loader_batch_matches_jax(run):
    got, want = run.batches["torch"], run.batches["jax"]
    assert got["points"].shape == (2, NUM_POINTS, 5) and got["gt_boxes"].shape == (2, 32, 10)
    np.testing.assert_array_equal(got["points"], want["points"])
    np.testing.assert_array_equal(got["gt_boxes"], want["gt_boxes"])
    gt = got["gt_boxes"][np.abs(got["gt_boxes"]).sum(-1) > 0]
    assert np.isfinite(gt).all() and set(np.unique(gt[:, 9])) == set(
        range(1, run.num_class + 1))


def test_train_targets_and_losses_match_jax(run):
    """Anchor labels equal; the 10-column targets within 1e-6; every loss
    (classification, the (cos, sin) box loss with its velocity columns,
    direction) within rtol 1e-4 of JAX's."""
    run.port.load_state_dict(grid_state_dict_from_jax(run.params, run.stats0, run.cfg))
    run.port.train()
    b = run.batches["torch"]
    out = run.port(torch.from_numpy(b["points"]), torch.from_numpy(b["gt_boxes"]),
                   max_voxels=MAX_VOXELS)
    _, metrics = api.compute_loss(out, None, run.cfg, run.num_class)
    want = run.out
    labels = out["box_cls_labels"].numpy()
    np.testing.assert_array_equal(labels, want["box_cls_labels"])
    assert (labels > 0).sum() > 0
    np.testing.assert_allclose(out["box_reg_targets"].numpy(), want["box_reg_targets"],
                               rtol=1e-6, atol=1e-6)
    assert out["box_reg_targets"].shape[-1] == 10
    assert set(metrics) == set(run.metrics)
    for name, value in metrics.items():
        np.testing.assert_allclose(value.item(), run.metrics[name], rtol=1e-4, err_msg=name)


def test_eval_multi_class_nms_matches_jax(run):
    """The decoded 9-column boxes within 1e-4; the multi-class NMS's kept
    slots and labels equal, boxes and scores within 1e-4."""
    run.port.load_state_dict(grid_state_dict_from_jax(run.params, run.stats1, run.cfg))
    run.port.eval()
    with torch.inference_mode():
        out = run.port(torch.from_numpy(run.batches["torch"]["points"]), max_voxels=MAX_VOXELS)
    for key in ("batch_cls_preds", "batch_box_preds"):
        np.testing.assert_allclose(out[key].numpy(), run.eval[key], **TOL, err_msg=key)
    final, ref = api.post_process(out, run.cfg), run.final
    np.testing.assert_array_equal(final["valid"].numpy(), ref["valid"])
    np.testing.assert_array_equal(final["labels"].numpy(), ref["labels"])
    v = final["valid"].numpy()
    assert v.sum() > 0
    np.testing.assert_allclose(final["boxes"].numpy()[v], ref["boxes"][v], **TOL)
    np.testing.assert_allclose(final["scores"].numpy(), ref["scores"], **TOL)
