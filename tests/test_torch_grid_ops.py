"""The grid detectors' building blocks in modest_tpu_torch against the JAX
package on the same inputs (numpy, from a seed): voxelization, the masked
and 2-D batch norms, the gather-scatter sparse convs, height compression,
anchors and targets, and the post-processing NMS on both sides of the JAX
package's 1024-candidate route switch."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modest_tpu.models import grid_detectors as jgd
from modest_tpu.models import sparse_conv as jsc
from modest_tpu.models import voxelize as jvx
from modest_tpu.models.box_coders import ResidualCoder as JResidualCoder
from modest_tpu.models.layers import MaskedBatchNorm as JMaskedBatchNorm
from modest_tpu.utils.config import Config as JConfig
from modest_tpu_torch.models import grid_detectors as gd
from modest_tpu_torch.models import sparse_conv as sc
from modest_tpu_torch.models import voxelize as vx
from modest_tpu_torch.models.box_coders import ResidualCoder
from modest_tpu_torch.models.layers import BatchNorm2d, MaskedBatchNorm
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

PCR = [0.0, -8.0, -3.0, 16.0, 8.0, 1.0]


def _scans(seed, b=2, n=700, spread=1.1):
    """(B, N, 4) points; some fall outside PCR (spread > 1)."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(0, 1, (b, n, 4)).astype(np.float32)
    lo, hi = np.array(PCR[:3]), np.array(PCR[3:])
    mid, half = (lo + hi) / 2, (hi - lo) / 2 * spread
    pts[..., :3] = (mid + (pts[..., :3] * 2 - 1) * half).astype(np.float32)
    return pts


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("vs,gs", [([0.5, 0.5, 4.0], (32, 32, 1)),
                                   ([0.5, 0.5, 0.25], (32, 32, 16))])
def test_point_voxel_coords_and_pillar_stats_match_jax(vs, gs):
    pts = _scans(0)
    coords, valid = vx.point_voxel_coords(torch.from_numpy(pts), PCR, vs, gs)
    cnt, mean, key = vx.pillar_stats(torch.from_numpy(pts), valid, coords[..., :2], gs[0], gs[1])
    for i in range(len(pts)):
        jc, jv = jvx.point_voxel_coords(jnp.asarray(pts[i]), PCR, vs, gs)
        jv = np.asarray(jv)
        np.testing.assert_array_equal(_np(valid[i]), jv)
        assert 0 < jv.sum() < len(jv)
        np.testing.assert_array_equal(_np(coords[i])[jv], np.asarray(jc)[jv])
        jcnt, jmean, jkey = jvx.pillar_stats(jnp.asarray(pts[i]), jnp.asarray(jv), jc[:, :2],
                                             gs[0], gs[1])
        np.testing.assert_array_equal(_np(key[i]), np.asarray(jkey))
        np.testing.assert_array_equal(_np(cnt[i])[jv], np.asarray(jcnt)[jv])
        np.testing.assert_allclose(_np(mean[i])[jv], np.asarray(jmean)[jv], rtol=0, atol=1e-6)


def test_scatter_max_bev_matches_jax_with_its_gradient():
    """Values and the gradient of the segment max (ties included: the
    features are quantised, so points of a pillar tie at its max)."""
    pts = _scans(1)
    nx = ny = 32
    coords, valid = vx.point_voxel_coords(torch.from_numpy(pts), PCR, [0.5, 0.5, 4.0],
                                          (nx, ny, 1))
    _, _, key = vx.pillar_stats(torch.from_numpy(pts), valid, coords[..., :2], nx, ny)
    rng = np.random.RandomState(2)
    feats = np.round(rng.uniform(0, 1, (*pts.shape[:2], 6)) * 4).astype(np.float32) / 4
    cot = rng.normal(size=(len(pts), 6, ny, nx)).astype(np.float32)
    f = torch.from_numpy(feats).requires_grad_()
    bev = vx.scatter_max_bev(f, key, valid, nx, ny)
    (bev * torch.from_numpy(cot)).sum().backward()

    def jloss(jf):
        total = 0.0
        for i in range(len(pts)):
            jb = jvx.scatter_max_bev(jf[i], jnp.asarray(_np(key[i])), jnp.asarray(_np(valid[i])),
                                     nx, ny)
            total = total + (jnp.transpose(jb, (2, 0, 1)) * cot[i]).sum()
        return total

    jb = np.stack([np.asarray(jvx.scatter_max_bev(
        jnp.asarray(feats[i]), jnp.asarray(_np(key[i])), jnp.asarray(_np(valid[i])), nx, ny))
        for i in range(len(pts))])
    np.testing.assert_array_equal(_np(bev), jb.transpose(0, 3, 1, 2))
    jgrad = np.asarray(jax.grad(jloss)(jnp.asarray(feats)))
    np.testing.assert_allclose(_np(f.grad), jgrad, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("max_voxels", [64, 2000])
def test_voxelize_sparse_matches_jax(max_voxels):
    """Keys, coords and validity equal; means within 1e-6. At 64 the cap
    bites and both keep the lowest keys."""
    pts = _scans(3)
    vs, gs = [0.5, 0.5, 0.25], (32, 32, 16)
    coords, valid = vx.point_voxel_coords(torch.from_numpy(pts), PCR, vs, gs)
    vc, vf, vv, vk = vx.voxelize_sparse(torch.from_numpy(pts), valid, coords, max_voxels, *gs)
    occupied = []
    for i in range(len(pts)):
        jc, jv = jvx.point_voxel_coords(jnp.asarray(pts[i]), PCR, vs, gs)
        jvc, jvf, jvv, jvk = jvx.voxelize_sparse(jnp.asarray(pts[i]), jv, jc, max_voxels, *gs)
        np.testing.assert_array_equal(_np(vk[i]), np.asarray(jvk))
        np.testing.assert_array_equal(_np(vv[i]), np.asarray(jvv))
        np.testing.assert_array_equal(_np(vc[i]), np.asarray(jvc))
        np.testing.assert_allclose(_np(vf[i]), np.asarray(jvf), rtol=0, atol=1e-6)
        occupied.append(int(np.asarray(jvv).sum()))
    in_range, occ, kept, dropped = vx.voxel_counts(torch.from_numpy(pts), PCR, vs, gs,
                                                   max_voxels)
    assert _np(kept).tolist() == occupied
    if max_voxels == 64:
        assert (_np(occ) > 64).all() and (_np(dropped) > 0).all()
    else:
        assert (_np(dropped) == 0).all() and (_np(occ) == _np(kept)).all()
    assert (_np(in_range) == _np(valid.sum(1))).all()


def test_masked_batch_norm_matches_jax_in_train_and_eval():
    rng = np.random.RandomState(4)
    x = rng.normal(1.0, 2.0, (3, 50, 8)).astype(np.float32)
    mask = rng.uniform(size=(3, 50)) < 0.6
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.normal(size=8).astype(np.float32)
    jm = JMaskedBatchNorm()
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.zeros(8), "var": jnp.ones(8)}}
    jy, mut = jm.apply(variables, jnp.asarray(x), jnp.asarray(mask), train=True,
                       mutable=["batch_stats"])
    bn = MaskedBatchNorm(8).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    y = bn(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(_np(y), np.asarray(jy), rtol=1e-5, atol=1e-6)
    assert (_np(y)[~mask] == 0).all()
    np.testing.assert_allclose(_np(bn.running_mean), np.asarray(mut["batch_stats"]["mean"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(bn.running_var), np.asarray(mut["batch_stats"]["var"]),
                               rtol=0, atol=1e-6)
    jy_eval = jm.apply({"params": variables["params"], "batch_stats": mut["batch_stats"]},
                       jnp.asarray(x), jnp.asarray(mask), train=False)
    np.testing.assert_allclose(_np(bn.eval()(torch.from_numpy(x), torch.from_numpy(mask))),
                               np.asarray(jy_eval), rtol=1e-5, atol=1e-6)


def test_batch_norm_2d_trains_as_flax_batch_norm():
    import flax.linen as nn

    rng = np.random.RandomState(5)
    x = rng.normal(0.5, 3.0, (2, 6, 7, 5)).astype(np.float32)  # NHWC
    jbn = nn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    scale = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.zeros(5) + 0.3},
                 "batch_stats": variables["batch_stats"]}
    jy, mut = jbn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = BatchNorm2d(5).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.fill_(0.3)
    y = bn(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(_np(y).transpose(0, 2, 3, 1), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_np(bn.running_mean), np.asarray(mut["batch_stats"]["mean"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(bn.running_var), np.asarray(mut["batch_stats"]["var"]),
                               rtol=0, atol=1e-6)


SHAPE = (9, 12, 14)  # zyx


def _sparse_set(seed, b=2, v=96, n_real=(70, 55), c=5, shape=SHAPE):
    rng = np.random.RandomState(seed)
    big = int(np.prod(shape))
    keys = np.full((b, v), big, np.int64)
    for i in range(b):
        keys[i, :n_real[i]] = np.sort(rng.choice(big, n_real[i], replace=False))
    nz, ny, nx = shape
    coords = np.stack([keys // (ny * nx), (keys // nx) % ny, keys % nx], -1)
    valid = keys < big
    feats = (rng.normal(size=(b, v, c)) * valid[..., None]).astype(np.float32)
    return feats, coords, keys, valid


def _jax_batch(feats, coords, keys, valid):
    return (jnp.asarray(feats), jnp.asarray(coords, jnp.int32), jnp.asarray(keys, jnp.int32),
            jnp.asarray(valid))


def test_submconv3d_matches_jax():
    feats, coords, keys, valid = _sparse_set(6)
    jm = jsc.SubMConv3d(7)
    params = jm.init(jax.random.PRNGKey(1), *_jax_batch(feats, coords, keys, valid), SHAPE)
    jy = jm.apply(params, *_jax_batch(feats, coords, keys, valid), SHAPE)
    conv = sc.SubMConv3d(5, 7)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.asarray(params["params"]["kernel"]).reshape(
            conv.weight.shape)))
    tk, tv, tc = torch.from_numpy(keys), torch.from_numpy(valid), torch.from_numpy(coords)
    rows = sc.neighbor_index(tk, tv, tc, SHAPE, sc.OFFSETS3)
    y = conv(torch.from_numpy(feats), rows, tv)
    np.testing.assert_allclose(_np(y), np.asarray(jy), rtol=1e-5, atol=1e-6)
    g = sc.gather_neighbors(torch.from_numpy(feats), tk, tv, tc, SHAPE)
    jg = jsc.gather_neighbors(jnp.asarray(feats[0]), jnp.asarray(keys[0], jnp.int32),
                              jnp.asarray(valid[0]), jnp.asarray(coords[0], jnp.int32), SHAPE)
    np.testing.assert_array_equal(_np(g[0]), np.asarray(jg))


@pytest.mark.parametrize("stride,padding,kernel", [((2, 2, 2), (1, 1, 1), (3, 3, 3)),
                                                   ((2, 2, 2), (0, 1, 1), (3, 3, 3)),
                                                   ((2, 1, 1), (0, 0, 0), (3, 1, 1))])
def test_sparse_conv3d_and_its_active_set_match_jax(stride, padding, kernel):
    """downsample_active_set's sets equal per scan (with a cap that bites),
    SparseConv3d's outputs within rtol 1e-5 (VoxelBackBone8x's three kinds:
    the stage openers and conv_out)."""
    feats, coords, keys, valid = _sparse_set(7)
    s_out = jsc._down_shape(SHAPE, stride, padding, kernel)
    tk, tv, tc = torch.from_numpy(keys), torch.from_numpy(valid), torch.from_numpy(coords)
    for cap in (40, 96):
        oc, ok, ov = sc.downsample_active_set(tc, tv, s_out, stride, padding, cap)
        for i in range(len(keys)):
            joc, jok, jov = jsc.downsample_active_set(
                jnp.asarray(coords[i], jnp.int32), jnp.asarray(keys[i], jnp.int32),
                jnp.asarray(valid[i]), SHAPE, s_out, jnp.array(stride), jnp.array(padding), cap)
            np.testing.assert_array_equal(_np(ok[i]), np.asarray(jok))
            np.testing.assert_array_equal(_np(ov[i]), np.asarray(jov))
            np.testing.assert_array_equal(_np(oc[i])[_np(ov[i])], np.asarray(joc)[np.asarray(jov)])
    jm = jsc.SparseConv3d(6, stride, padding, kernel)
    params = jm.init(jax.random.PRNGKey(2), *_jax_batch(feats, coords, keys, valid), SHAPE, s_out)
    jy, jc, jk, jv = jm.apply(params, *_jax_batch(feats, coords, keys, valid), SHAPE, s_out)
    conv = sc.SparseConv3d(5, 6, stride, padding, kernel)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.asarray(params["params"]["kernel"]).reshape(
            conv.weight.shape)))
    y, c, k, v = conv(torch.from_numpy(feats), tc, tk, tv, SHAPE, s_out)
    np.testing.assert_array_equal(_np(k), np.asarray(jk))
    np.testing.assert_array_equal(_np(v), np.asarray(jv))
    np.testing.assert_allclose(_np(y), np.asarray(jy), rtol=1e-5, atol=1e-6)


def test_height_compress_orders_channels_as_jax():
    feats, coords, keys, valid = _sparse_set(8, c=3, shape=(2, 5, 6), v=40, n_real=(30, 12))
    bev = sc.height_compress(torch.from_numpy(feats), torch.from_numpy(keys),
                             torch.from_numpy(valid), (2, 5, 6))
    for i in range(len(feats)):
        jb = jsc._height_compress(jnp.asarray(feats[i]), jnp.asarray(keys[i], jnp.int32),
                                  jnp.asarray(valid[i]), (2, 5, 6))
        np.testing.assert_array_equal(_np(bev[i]).transpose(1, 2, 0), np.asarray(jb))


ANCHOR_CFG = {"class_name": "Dynamic", "anchor_sizes": [[2.0, 1.0, 1.7]],
              "anchor_rotations": [0, 1.57], "anchor_bottom_heights": [-1.6],
              "align_center": False, "feature_map_stride": 2, "matched_threshold": 0.5,
              "unmatched_threshold": 0.35}


@pytest.mark.parametrize("align_center,stride", [(False, 2), (True, 8)])
def test_anchors_equal_jax(align_center, stride):
    cfg = {**ANCHOR_CFG, "align_center": align_center, "feature_map_stride": stride}
    got, fmap = gd.generate_anchors([cfg], (64, 48, 1), PCR)
    want, jfmap = jgd.generate_anchors([cfg], (64, 48, 1), PCR)
    assert fmap == jfmap
    np.testing.assert_array_equal(got, want)


def test_anchor_targets_equal_jax():
    """Positives, ignores, forced matches, padded gt rows and a scan with no
    gt at all."""
    anchors, _ = gd.generate_anchors([ANCHOR_CFG], (32, 32, 1), PCR)
    rng = np.random.RandomState(9)
    gt = np.zeros((3, 6, 8), np.float32)
    for i, n in enumerate((5, 2)):
        pick = anchors[rng.choice(len(anchors), n, replace=False)]
        gt[i, :n, :7] = pick + rng.normal(0, [0.3, 0.3, 0.1, 0.2, 0.1, 0.1, 0.4], (n, 7))
        gt[i, :n, 7] = 1
    gt[0, 4, 3:5] = 0.3  # a small box: only its forced match makes it positive
    labels, targets, weights = gd.assign_anchor_targets(
        torch.from_numpy(anchors), torch.from_numpy(gt), ResidualCoder(), 0.5, 0.35)
    jl, jt, jw = jgd.assign_anchor_targets(jnp.asarray(anchors), jnp.asarray(gt),
                                           JResidualCoder(), 0.5, 0.35)
    np.testing.assert_array_equal(_np(labels), np.asarray(jl))
    assert (_np(labels) > 0).sum() > 0 and (_np(labels) < 0).sum() > 0
    assert (_np(labels[2]) == 0).all()
    np.testing.assert_array_equal(_np(weights), np.asarray(jw))
    np.testing.assert_allclose(_np(targets), np.asarray(jt), rtol=1e-6, atol=1e-6)
    iou = gd.aligned_bev_iou(torch.from_numpy(anchors), torch.from_numpy(gt[0, :, :7]))
    np.testing.assert_allclose(_np(iou), np.asarray(jgd.aligned_bev_iou(
        jnp.asarray(anchors), jnp.asarray(gt[0, :, :7]))), rtol=1e-6, atol=1e-7)


def _post_cfg(pre_max):
    return {"SCORE_THRESH": 0.1, "NMS_CONFIG": {"MULTI_CLASSES_NMS": False,
                                                "NMS_THRESH": 0.01,
                                                "NMS_PRE_MAXSIZE": pre_max,
                                                "NMS_POST_MAXSIZE": 500}}


@pytest.mark.parametrize("pre_max", [512, 1100])
def test_grid_post_process_keeps_the_jax_boxes(pre_max):
    """Boxes 1:1 with the JAX package's at NMS_PRE_MAXSIZE below 1024 (its
    full-matrix route) and above (its blocked route); tied scores (a third
    of the logits share four values) keep the lower anchor first. The
    scores agree within a last-bit sigmoid difference."""
    rng = np.random.RandomState(10)
    b, a = 2, 1500
    boxes = np.zeros((b, a, 7), np.float32)
    boxes[..., 0] = rng.uniform(0, 60, (b, a))
    boxes[..., 1] = rng.uniform(-30, 30, (b, a))
    boxes[..., 2] = rng.uniform(-1, 0, (b, a))
    boxes[..., 3:6] = rng.uniform([1.5, 0.8, 1.4], [4.5, 2.0, 2.0], (b, a, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (b, a))
    logits = rng.normal(-1.0, 1.5, (b, a, 1)).astype(np.float32)
    ties = rng.uniform(size=(b, a)) < 0.33
    logits[ties, 0] = rng.choice([-0.5, 0.0, 0.7, 1.2], ties.sum())
    got = gd.grid_post_process({"batch_cls_preds": torch.from_numpy(logits),
                                "batch_box_preds": torch.from_numpy(boxes)},
                               JConfig(_post_cfg(pre_max)))
    want = jgd.grid_post_process({"batch_cls_preds": jnp.asarray(logits),
                                  "batch_box_preds": jnp.asarray(boxes)},
                                 JConfig(_post_cfg(pre_max)))
    assert got["rois"] is None
    for i in range(b):
        v, jv = _np(got["valid"][i]), np.asarray(want["valid"][i])
        assert v.sum() == jv.sum() > 20
        np.testing.assert_array_equal(_np(got["boxes"][i])[v], np.asarray(want["boxes"][i])[jv])
        # torch's and XLA's sigmoids may differ in the last bit
        np.testing.assert_allclose(_np(got["scores"][i])[v],
                                   np.asarray(want["scores"][i])[jv], rtol=1e-6, atol=0)
        np.testing.assert_array_equal(_np(got["labels"][i])[v],
                                      np.asarray(want["labels"][i])[jv])


@pytest.mark.parametrize("stride,padding", [((1, 1), (1, 1)), ((2, 2), (0, 0))])
def test_im2col_conv_route_computes_conv2d(stride, padding):
    """The BEV convs' second route (cuDNN off: im2col and a GEMM, with its own
    backward) is conv2d, values and gradients."""
    from modest_tpu_torch.models.layers import Conv2d, _Im2colConv2d

    gen = torch.Generator().manual_seed(11)
    x = torch.randn(2, 5, 9, 11, generator=gen, requires_grad=True)
    w = torch.randn(7, 5, 3, 3, generator=gen, requires_grad=True)
    cot = torch.randn(2, 7, (9 + 2 * padding[0] - 3) // stride[0] + 1,
                      (11 + 2 * padding[1] - 3) // stride[1] + 1, generator=gen)
    got = _Im2colConv2d.apply(x, w, stride, padding)
    gx, gw = torch.autograd.grad((got * cot).sum(), (x, w))
    want = torch.nn.functional.conv2d(x, w, None, stride, padding)
    wx, ww = torch.autograd.grad((want * cot).sum(), (x, w))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gx, wx, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gw, ww, rtol=1e-5, atol=1e-5)
    conv = Conv2d(5, 7, 3, stride=stride, padding=padding)
    conv.weight.data.copy_(w.detach())
    torch.testing.assert_close(conv(x), want)  # the CPU takes nn.Conv2d


def test_conv_route_rule_sends_second_level1_to_im2col():
    """``Conv2d``'s route is a rule of the shape: of the BEV conv shapes of
    the Lyft and KITTI configs and the CBGS SECOND (``tools/grid_probe.py``'s
    table), only SECOND's stride-1 convs to 128 channels leave cuDNN: the
    256-channel openers on every map, the 128-channel convs on Lyft's 200 x
    226 and KITTI's 200 x 176 level-1 maps."""
    from modest_tpu_torch.models.layers import conv_uses_cudnn
    from modest_tpu_torch.tools.grid_probe import CONV_SHAPES

    off = {name for name, (cin, cout, h, w, stride, _) in CONV_SHAPES.items()
           if not conv_uses_cudnn(cin, cout, (h, w), (stride, stride))}
    assert off == {"second_l1_first", "second_l1", "kitti_second_l1_first", "kitti_second_l1",
                   "cbgs_second_l1_first"}
