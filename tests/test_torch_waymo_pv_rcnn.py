"""The slice whole on the CPU: a narrow Waymo PV-RCNN (three classes with
Waymo's anchors, 5-feature points, 64 keypoints, a coarse voxel grid over
Waymo's range) fed the port loader's test batch of a seeded full-density
tree, against JAX's PV-RCNN fed JAX's loader batch of the same tree. The
JAX variables are seeded from ``jax.eval_shape`` of its init and carried
over by ``models/convert.py::pvrcnn_state_dict_from_jax``; one JAX eval
forward is taken, no JAX gradient."""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from modest_tpu.data import loader as jloader
from modest_tpu.models import pv_rcnn as jpv
from modest_tpu.utils.config import Config as JConfig
from modest_tpu_torch import configs
from modest_tpu_torch.data import loader as tloader
from modest_tpu_torch.models import api, build_network
from modest_tpu_torch.models.convert import pvrcnn_state_dict_from_jax
from modest_tpu_torch.tools import synth_infos
from modest_tpu_torch.utils.config import Config
from tests.test_torch_pv_rcnn import pvrcnn_model_cfg
from tests.torch_detector_pair import MAX_VOXELS, run_jax
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = {"rtol": 1e-4, "atol": 1e-4}  # tests/test_torch_pv_rcnn.py's
NUM_POINTS = 4096
VOXEL_SIZE = [1.175, 1.175, 0.15]  # Waymo's 150.4 m x 6 m range on a 128 x 128 x 40 grid
NAMES = configs.WAYMO_CLASS_NAMES


def waymo_pv_rcnn_cfg():
    cfg = pvrcnn_model_cfg()
    cfg["DENSE_HEAD"]["ANCHOR_GENERATOR_CONFIG"] = copy.deepcopy(
        configs.WAYMO_CONFIGS["pv_rcnn"]["MODEL"]["DENSE_HEAD"]["ANCHOR_GENERATOR_CONFIG"])
    return cfg


def data_cfg(root, conf):
    cfg = copy.deepcopy(configs.WAYMO_CONFIGS["pv_rcnn"]["DATA_CONFIG"])
    cfg["DATA_PATH"] = str(root)
    cfg["SAMPLED_INTERVAL"] = {"train": 1, "test": 1}
    cfg["DATA_PROCESSOR"][1]["NUM_POINTS"] = {"train": NUM_POINTS, "test": NUM_POINTS}
    cfg["DATA_PROCESSOR"][3]["VOXEL_SIZE"] = VOXEL_SIZE
    return conf(cfg)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("waymo")
    synth_infos.write_waymo_tree(root, 2, rng=np.random.RandomState(0), full_density=True,
                                 n_val=2, points=6000)
    batches, sets = {}, {}
    for side, mod, conf in (("jax", jloader, JConfig), ("torch", tloader, Config)):
        sets[side], loader = mod.build_dataloader(data_cfg(root, conf), NAMES, batch_size=2,
                                                  training=False)
        batches[side] = next(iter(loader))
    cfg = waymo_pv_rcnn_cfg()
    jcfg = JConfig(cfg)
    ds = sets["jax"]
    jmodel = jpv.PVRCNN(model_cfg=jcfg, num_class=3, point_cloud_range=ds.point_cloud_range,
                        voxel_size=ds.voxel_size, grid_size=tuple(int(g) for g in ds.grid_size))
    b = batches["jax"]
    out = run_jax(jmodel, jcfg, None, forwards=("eval",), batch=(b["points"], b["gt_boxes"]))
    out.cfg, out.jcfg, out.batches, out.dataset = Config(cfg), jcfg, batches, sets["torch"]
    return out


def test_loader_batches_match_jax(run):
    got, want = run.batches["torch"], run.batches["jax"]
    assert got["points"].shape == (2, NUM_POINTS, 5) and got["gt_boxes"].shape[-1] == 8
    np.testing.assert_array_equal(got["points"], want["points"])
    np.testing.assert_array_equal(got["gt_boxes"], want["gt_boxes"])
    assert got["frame_id"] == want["frame_id"] and got["metadata"] == want["metadata"]


def test_port_takes_five_features_from_the_loader(run):
    """``build_network`` reads the point width off the dataset's encoder:
    the raw-points VSA source takes the 2 features past xyz (plus xyz)."""
    assert run.dataset.point_feature_encoder.num_point_features == 5
    port = build_network(run.cfg, 3, device="cpu", dataset=run.dataset)
    first = port.state_dict()["vsa.raw_points.0.0.weight"]
    assert first.shape[1] == 3 + 2


def test_eval_forward_and_boxes_match_jax(run):
    """Keypoints equal; RoIs, RCNN outputs and the decoded boxes within
    1e-4; the final boxes and scores 1:1 with the post-processing of JAX's
    outputs, at the tolerances of tests/test_torch_pv_rcnn.py."""
    port = build_network(run.cfg, 3, device="cpu", dataset=run.dataset)
    port.load_state_dict(pvrcnn_state_dict_from_jax(run.params, run.stats1, run.jcfg))
    port.eval()
    with torch.inference_mode():
        out = port(torch.from_numpy(run.batches["torch"]["points"]), max_voxels=MAX_VOXELS)
    want = run.eval
    assert out["keypoints"].shape == (2, 64, 3)
    np.testing.assert_array_equal(out["keypoints"].numpy(), want["keypoints"])
    np.testing.assert_array_equal(out["roi_valid"].numpy(), want["roi_valid"])
    for key in ("rois", "rcnn_cls", "rcnn_reg", "pkw_logits", "batch_cls_preds",
                "batch_box_preds"):
        np.testing.assert_allclose(out[key].numpy(), want[key], **TOL, err_msg=key)
    final = api.post_process(out, run.cfg)
    ref = api.post_process({k: torch.from_numpy(np.array(want[k])) for k in
                            ("batch_cls_preds", "batch_box_preds", "roi_valid", "roi_labels",
                             "rois")}, run.cfg)
    for i in range(2):
        v, jv = final["valid"][i].numpy(), ref["valid"][i].numpy()
        assert v.sum() == jv.sum() > 0
        np.testing.assert_allclose(final["boxes"][i].numpy()[v], ref["boxes"][i].numpy()[jv],
                                   **TOL)
        np.testing.assert_allclose(final["scores"][i].numpy()[v], ref["scores"][i].numpy()[jv],
                                   **TOL)
        np.testing.assert_array_equal(final["labels"][i].numpy()[v],
                                      ref["labels"][i].numpy()[jv])
