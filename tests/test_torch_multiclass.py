"""The multi-class pieces of modest_tpu_torch's grid detectors against the JAX
package on the same numpy-seeded inputs: the 9-code (cos, sin) residual
coder, multi-config anchors with their per-anchor thresholds and classes,
the class-aware and the grouped assigners, ATSS, class-agnostic and
multi-class NMS on tied scores, and ``VoxelResBackBone8x`` (JAX's variables
seeded from ``jax.eval_shape`` of its init). Labels and kept indices are
held exactly, floats within 1e-6 to 1e-4. The 3-class detectors whole are
in tests/test_torch_multiclass_models.py."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modest_tpu.models import anchor_head_multi as jahm
from modest_tpu.models import box_coders as jbc
from modest_tpu.models import grid_detectors as jgd
# imported before any jit: its module constants must not be made under a trace
from modest_tpu.models import sparse_conv as jsc
from modest_tpu.ops import iou3d as jiou
from modest_tpu_torch.models import anchor_head_multi as ahm
from modest_tpu_torch.models import grid_detectors as gd
from modest_tpu_torch.models import sparse_conv as sc
from modest_tpu_torch.models.box_coders import ResidualCoder
from modest_tpu_torch.models.convert import _plain, _sparse_state_from_jax
from modest_tpu_torch.models.voxelize import point_voxel_coords, voxelize_sparse
from modest_tpu_torch.ops import iou3d
from tests.test_torch_grid_detectors import GEOMETRY, PCR, toy_batch
from tests.torch_detector_pair import MAX_VOXELS, seeded
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

VS, GS, GT_XY = GEOMETRY["second"]
KITTI_ANCHORS = [  # kitti_models/second.yaml, at the toy grid's stride
    {"class_name": "Car", "anchor_sizes": [[3.9, 1.6, 1.56]], "anchor_rotations": [0, 1.57],
     "anchor_bottom_heights": [-1.78], "align_center": False, "feature_map_stride": 8,
     "matched_threshold": 0.6, "unmatched_threshold": 0.45},
    {"class_name": "Pedestrian", "anchor_sizes": [[0.8, 0.6, 1.73]],
     "anchor_rotations": [0, 1.57], "anchor_bottom_heights": [-0.6], "align_center": False,
     "feature_map_stride": 8, "matched_threshold": 0.5, "unmatched_threshold": 0.35},
    {"class_name": "Cyclist", "anchor_sizes": [[1.76, 0.6, 1.73]],
     "anchor_rotations": [0, 1.57], "anchor_bottom_heights": [-0.6], "align_center": False,
     "feature_map_stride": 8, "matched_threshold": 0.5, "unmatched_threshold": 0.35},
]
NAMES = ("Car", "Pedestrian", "Cyclist")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def three_class_batch():
    """The toy scans with a car on a stride-8 anchor site, a pedestrian on
    one and a cyclist on one."""
    pts, gt1 = toy_batch(0, GT_XY)
    gt = np.zeros((2, 4, 8), np.float32)
    x, y = GT_XY
    gt[:, 0] = [x, y, -0.9, 3.9, 1.6, 1.56, 0.0, 1]
    gt[:, 1] = [x - 16 / 3, y, -0.2, 0.8, 0.6, 1.73, 1.57, 2]
    gt[1, 2] = [x, y + 16 / 3, -0.2, 1.76, 0.6, 1.73, 0.0, 3]
    gt[1, 3] = gt1[1, 1]  # a second car off the anchor grid
    return pts, gt


def random_boxes(rng, n, spread=20.0):
    boxes = np.zeros((n, 7), np.float32)
    boxes[:, :2] = rng.uniform(-spread, spread, (n, 2))
    boxes[:, 2] = rng.uniform(-2, 0, n)
    boxes[:, 3:6] = rng.uniform(0.5, 4.5, (n, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return boxes


# --- the coder ------------------------------------------------------------------


@pytest.mark.parametrize("code_size,sincos", [(7, False), (9, False), (9, True)])
def test_residual_coder_matches_jax_and_round_trips(code_size, sincos):
    """Encode and decode within 1e-6 of JAX's; a 9-code (cos, sin) coder
    gives 10 residual columns and decodes back to 9 box columns."""
    rng = np.random.RandomState(0)
    boxes = np.concatenate([random_boxes(rng, 64), rng.uniform(-3, 3, (64, 2))], -1)
    boxes = boxes[:, :code_size].astype(np.float32)
    anchors = random_boxes(rng, 64)
    coder = ResidualCoder(code_size, sincos)
    jcoder = jbc.ResidualCoder(code_size=code_size, encode_angle_by_sincos=sincos)
    enc = coder.encode(_t(boxes), _t(anchors))
    assert enc.shape[-1] == coder.code_size == code_size + int(sincos)
    want = jcoder.encode(jnp.asarray(boxes), jnp.asarray(anchors))
    np.testing.assert_allclose(enc.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    dec = coder.decode(enc, _t(anchors))
    want = jcoder.decode(jnp.asarray(enc.numpy()), jnp.asarray(anchors))
    np.testing.assert_allclose(dec.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert dec.shape[-1] == code_size
    turn = np.angle(np.exp(1j * (dec[:, 6].numpy() - boxes[:, 6])))
    np.testing.assert_allclose(turn, 0.0, atol=1e-5)
    keep = [i for i in range(code_size) if i != 6]
    np.testing.assert_allclose(dec.numpy()[:, keep], boxes[:, keep], rtol=1e-5, atol=1e-5)


# --- anchors and assigners --------------------------------------------------------


def test_multi_config_anchors_thresholds_and_classes_equal_jax():
    """``single_head_anchor_setup`` (location-major, per-anchor thresholds
    and classes) and ``generate_multiclass_anchors`` (class-major by group)
    give JAX's arrays exactly."""
    got = gd.single_head_anchor_setup(KITTI_ANCHORS, GS, PCR)
    want = jgd.single_head_anchor_setup(KITTI_ANCHORS, GS, PCR)
    assert got[1] == want[1] == 6
    for a, b in zip(got[:1] + got[2:], want[:1] + want[2:]):
        np.testing.assert_array_equal(a, b)
    assert got[4][:6].tolist() == [1, 1, 2, 2, 3, 3]
    groups = [("Car",), ("Pedestrian", "Cyclist")]
    got = ahm.generate_multiclass_anchors(KITTI_ANCHORS, GS, PCR, list(NAMES), groups)
    want = jahm.generate_multiclass_anchors(KITTI_ANCHORS, GS, PCR, list(NAMES), groups)
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a, b)
    assert got[4] == want[4] == [32, 64]


def test_assign_anchor_targets_class_aware():
    """tests/test_grid_detectors.py's case: with anchor_cls an anchor only
    matches gt boxes of its own class."""
    anchors = torch.tensor([[10, 0, 0, 4, 2, 1.6, 0.0]] * 2)
    gt = torch.zeros(1, 1, 8)
    gt[0, 0] = torch.tensor([10, 0, 0, 4, 2, 1.6, 0.0, 2])
    labels, _, _ = gd.assign_anchor_targets(anchors, gt, ResidualCoder(), 0.6, 0.45,
                                            anchor_cls=torch.tensor([1, 2]))
    assert labels[0].tolist() == [0, 2]


def test_class_aware_assigner_matches_jax():
    """Per-anchor thresholds and classes over KITTI's 3-class anchor set,
    padded gt rows: labels exactly, targets within 1e-6."""
    anchors, _, m_thr, u_thr, a_cls = gd.single_head_anchor_setup(KITTI_ANCHORS, GS, PCR)
    _, gt = three_class_batch()
    got = gd.assign_anchor_targets(_t(anchors), _t(gt), ResidualCoder(), _t(m_thr), _t(u_thr),
                                   _t(a_cls))
    want = jgd.assign_anchor_targets(*map(jnp.asarray, (anchors, gt)), jbc.ResidualCoder(),
                                     *map(jnp.asarray, (m_thr, u_thr)),
                                     anchor_cls=jnp.asarray(a_cls))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert set(np.unique(got[0].numpy())) >= {0, 1, 2, 3}
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6, atol=1e-6)


def test_grouped_assigner_padded_gt_never_forces_and_matches_jax():
    """tests/test_grid_detectors.py's padded-gt case, then the grouped
    assigner on 10-column gt boxes (velocity, then the class) against JAX:
    labels exactly, targets and matched headings within 1e-6."""
    anchors = torch.tensor([[10, 1.8, 0, 4, 2, 1.6, 0.0], [50, 20, 0, 4, 2, 1.6, 0.0]])
    gt = torch.zeros(1, 3, 8)
    gt[0, 0] = torch.tensor([10, 0, 0, 4, 2, 1.6, 0.0, 1])
    labels, *_ = ahm.assign_multiclass_targets(anchors, torch.tensor([1, 1]),
                                               torch.full((2,), 0.6), torch.full((2,), 0.45),
                                               gt, ResidualCoder())
    assert labels[0].tolist() == [1, 0]

    groups = [("Car",), ("Pedestrian", "Cyclist")]
    anchors, acls, m_thr, u_thr, _ = ahm.generate_multiclass_anchors(
        KITTI_ANCHORS, GS, PCR, list(NAMES), groups)
    _, gt8 = three_class_batch()
    gt = np.concatenate([gt8[..., :7], np.random.RandomState(1).uniform(-2, 2, (2, 4, 2)),
                         gt8[..., 7:]], -1).astype(np.float32)
    gt[gt8[..., 7] == 0] = 0
    coder = ResidualCoder(9, True)
    got = ahm.assign_multiclass_targets(_t(anchors), _t(acls), _t(m_thr), _t(u_thr), _t(gt),
                                        coder)
    want = jahm.assign_multiclass_targets(*map(jnp.asarray, (anchors, acls, m_thr, u_thr, gt)),
                                          jbc.ResidualCoder(9, encode_angle_by_sincos=True))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert set(np.unique(got[0].numpy())) >= {0, 1, 2, 3}
    for a, b in ((got[1], want[1]), (got[3], want[3])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_atss_matches_jax():
    """tests/test_grid_detectors.py's ATSS case (48 anchors, top 5, two
    classes, padded gt) against JAX's: labels and weights exactly, targets
    within 1e-5."""
    rng = np.random.RandomState(0)
    anchors = np.zeros((48, 7), np.float32)
    anchors[:, 0] = rng.uniform(0, 40, 48)
    anchors[:, 1] = rng.uniform(-10, 10, 48)
    anchors[:, 3:6] = [4.0, 2.0, 1.6]
    gt = np.zeros((1, 5, 8), np.float32)
    gt[0, :3, 0] = [8.0, 20.0, 33.0]
    gt[0, :3, 1] = [-4.0, 2.0, 6.0]
    gt[0, :3, 3:6] = [4.2, 1.9, 1.5]
    gt[0, :3, 6] = [0.1, -0.3, 0.8]
    gt[0, :3, 7] = [1, 2, 1]
    got = gd.assign_targets_atss(_t(anchors), _t(gt), ResidualCoder(), 5)
    want = jax.jit(lambda a, g: jgd.assign_targets_atss(a, g, jbc.ResidualCoder(), 5))(
        jnp.asarray(anchors), jnp.asarray(gt))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert (got[0] > 0).sum() >= 3
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-5)



# --- NMS --------------------------------------------------------------------------


def _nms_case():
    """300 boxes in 6 clusters, two classes' scores in steps of 1/16 (many
    ties), some below the threshold and one not finite."""
    rng = np.random.RandomState(3)
    centres = rng.uniform(-20, 20, (6, 2))
    boxes = random_boxes(rng, 300)
    boxes[:, :2] = centres[rng.randint(0, 6, 300)] + rng.normal(0, 0.6, (300, 2))
    scores = (rng.randint(0, 16, (300, 2)) / 16).astype(np.float32)
    scores[7, 0] = np.nan
    return boxes, scores


@pytest.mark.parametrize("pre_maxsize", [None, 64])
def test_class_agnostic_and_multi_class_nms_match_jax(pre_maxsize):
    """``multi_classes_nms`` on a batch of two scans (the second reversed)
    against JAX's one scan at a time: validity, labels and scores equal,
    the kept indices equal where valid; ``class_agnostic_nms`` on a class's
    scores keeps that class's slots. With ``pre_maxsize`` 64 only the best
    64 (ties to the lower index) enter the NMS."""
    boxes, scores = _nms_case()
    batch = np.stack([scores, scores[::-1]]), np.stack([boxes, boxes[::-1]])
    got = iou3d.multi_classes_nms(_t(batch[0]), _t(batch[1]), 0.2, score_thresh=0.1,
                                  pre_maxsize=pre_maxsize, post_maxsize=64)
    for i in range(2):
        # eager: its per-class calls share one compile of the jitted ``nms_bev``
        want = jiou.multi_classes_nms(jnp.asarray(batch[0][i]), jnp.asarray(batch[1][i]), 0.2,
                                      score_thresh=0.1, pre_maxsize=pre_maxsize,
                                      post_maxsize=64)
        kept, labels, index, valid = (t[i].numpy() for t in got)
        np.testing.assert_array_equal(valid, np.asarray(want[3]))
        np.testing.assert_array_equal(labels, np.asarray(want[1]))
        np.testing.assert_array_equal(index[valid], np.asarray(want[2])[valid])
        np.testing.assert_array_equal(kept, np.asarray(want[0]))
        assert set(labels[valid]) == {1, 2} and 0 < valid[:64].sum() < 64
    for c in range(2):
        idx, mask = iou3d.class_agnostic_nms(_t(batch[0][..., c]), _t(batch[1]), 0.2,
                                             score_thresh=0.1, pre_maxsize=pre_maxsize,
                                             post_maxsize=64)
        sl = slice(64 * c, 64 * (c + 1))
        assert torch.equal(mask, got[3][:, sl]) and torch.equal(idx[mask], got[2][:, sl][mask])


# --- the residual sparse backbone ----------------------------------------------------


def test_voxel_res_backbone_matches_jax():
    """``VoxelResBackBone8x`` on the toy scans' voxels with JAX's seeded
    variables: the eval BEV map within 1e-5, and a train forward's map and
    running statistics."""
    pts, _ = toy_batch(0, GT_XY)
    p = torch.from_numpy(pts)
    coords, valid = point_voxel_coords(p, PCR, VS, GS)
    voxels = voxelize_sparse(p, valid, coords, MAX_VOXELS, *GS)
    vc, vf, vv, vk = voxels
    shape = (GS[2] + 1, GS[1], GS[0])
    args = [jnp.asarray(t.numpy()) for t in (vf, vc, vk, vv)]
    jm = jsc.VoxelResBackBone8x()
    params, stats = seeded(jax.eval_shape(
        lambda *a: jm.init(jax.random.PRNGKey(0), *a, shape, train=True), *args))

    def run(v, *a):
        bev, mut = jm.apply(v, *a, shape, train=True, mutable=["batch_stats"])
        return jm.apply(v, *a, shape, train=False), bev, mut["batch_stats"]

    want_eval, want_train, stats1 = jax.jit(run)({"params": params, "batch_stats": stats}, *args)
    port = sc.VoxelResBackBone8x(4)
    sd = {k: _t(v) for k, v in _sparse_state_from_jax(_plain(params), _plain(stats)).items()}
    port.load_state_dict(sd)
    assert len(sd) == len(port.state_dict())
    port.eval()
    with torch.no_grad():
        got = port(vf, vc, vk, vv, shape)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want_eval),
                               rtol=1e-5, atol=1e-5)
    port.train()
    got = port(vf, vc, vk, vv, shape)
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_train), rtol=1e-4, atol=1e-5)
    want_sd = _sparse_state_from_jax(_plain(params), _plain(stats1))
    own = port.state_dict()
    for k, v in want_sd.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(own[k].numpy(), v, rtol=1e-5, atol=1e-6, err_msg=k)
