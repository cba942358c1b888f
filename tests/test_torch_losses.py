"""Training targets and losses of the PyTorch port vs the JAX package on the
same inputs (numpy seeds): the losses of models/losses.py, the point
head's targets and loss, the RoI sampler with JAX's "sampler" draws handed
to the port, the canonical transform and the RoI head's loss.

Labels, sampled indices and masks must be equal; float results agree within
rtol 1e-5, atol 1e-6 (float32 on both sides, elementwise arithmetic in the
same order), IoUs within atol 1e-5 as in tests/test_torch_boxes.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modest_tpu.models import losses as jl
from modest_tpu.models import point_head as jph
from modest_tpu.models import roi_head as jrh
from modest_tpu.models.box_coders import PointResidualCoder as JPointCoder
from modest_tpu.models.box_coders import ResidualCoder as JResidualCoder
from modest_tpu.utils.config import Config as JConfig
from modest_tpu_torch.configs import POINTRCNN_DYNAMIC_OBJ
from modest_tpu_torch.models import losses as tl
from modest_tpu_torch.models import point_head as tph
from modest_tpu_torch.models import roi_head as trh
from modest_tpu_torch.models.box_coders import PointResidualCoder, ResidualCoder
from modest_tpu_torch.utils.config import Config
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-5, atol=1e-6)
TARGET_CFG = POINTRCNN_DYNAMIC_OBJ["ROI_HEAD"]["TARGET_CONFIG"]
MEAN_SIZE = POINTRCNN_DYNAMIC_OBJ["POINT_HEAD"]["TARGET_CONFIG"]["BOX_CODER_CONFIG"]["mean_size"]


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x)


def random_boxes(rng, shape):
    return np.concatenate([rng.uniform(-20, 20, (*shape, 2)), rng.uniform(-2, 0, (*shape, 1)),
                           rng.uniform(1.0, 4.5, (*shape, 3)),
                           rng.uniform(-np.pi, np.pi, (*shape, 1))], -1).astype(np.float32)


def test_elementwise_losses_equal_jax():
    rng = np.random.RandomState(0)
    logits = rng.normal(0, 3, (500, 3)).astype(np.float32)
    targets = (rng.rand(500, 3) > 0.7).astype(np.float32)
    weights = rng.rand(500).astype(np.float32)
    np.testing.assert_allclose(tl.sigmoid_ce_with_logits(_t(logits), _t(targets)).numpy(),
                               _np(jl.sigmoid_ce_with_logits(logits, targets)), **TOL)
    np.testing.assert_allclose(tl.sigmoid_focal_loss(_t(logits), _t(targets), _t(weights)).numpy(),
                               _np(jl.sigmoid_focal_loss(logits, targets, weights)), **TOL)
    diff = rng.normal(0, 0.3, (500, 7)).astype(np.float32)
    for beta in (1.0 / 9.0, 1.0, 0.0):
        np.testing.assert_allclose(tl.smooth_l1(_t(diff), beta).numpy(),
                                   _np(jl.smooth_l1(diff, beta)), **TOL)
    preds = rng.normal(0, 1, (2, 300, 7)).astype(np.float32)
    tgts = rng.normal(0, 1, (2, 300, 7)).astype(np.float32)
    tgts[0, :20, 3] = np.nan  # ignored entries
    w = rng.rand(2, 300).astype(np.float32)
    cw = [1.0, 1.0, 2.0, 1.0, 0.5, 1.0, 1.0]
    np.testing.assert_allclose(
        tl.weighted_smooth_l1(_t(preds), _t(tgts), _t(w), cw).numpy(),
        _np(jl.weighted_smooth_l1(preds, tgts, w, cw)), **TOL)
    probs = rng.rand(400).astype(np.float32)
    probs[:3] = [0.0, 1.0, 1e-9]
    labels = (rng.rand(400) > 0.5).astype(np.float32)
    np.testing.assert_allclose(tl.binary_cross_entropy(_t(probs), _t(labels)).numpy(),
                               _np(jl.binary_cross_entropy(probs, labels)), **TOL)
    a, b = random_boxes(rng, (200,)), random_boxes(rng, (200,))
    b[:50] = a[:50] + rng.normal(0, 0.1, (50, 7)).astype(np.float32)
    np.testing.assert_allclose(tl.corner_loss_lidar(_t(a), _t(b)).numpy(),
                               _np(jl.corner_loss_lidar(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5, atol=1e-5)


def scene(rng, b=2, n=2000, m=6, n_valid=(4, 0)):
    """Points around gt boxes (B, M, 8) with the class in the last column;
    the second scene may have no boxes at all."""
    gt = np.zeros((b, m, 8), np.float32)
    pts = rng.uniform(-20, 20, (b, n, 3)).astype(np.float32)
    pts[..., 2] = rng.uniform(-2, 0.5, (b, n))
    for i in range(b):
        k = n_valid[i]
        gt[i, :k, :7] = random_boxes(rng, (k,))
        gt[i, :k, 7] = 1
        for j in range(k):  # points inside and just around each box
            sl = slice(j * 150, (j + 1) * 150)
            local = rng.uniform(-0.6, 0.6, (150, 3)) * gt[i, j, 3:6]
            c, s = np.cos(gt[i, j, 6]), np.sin(gt[i, j, 6])
            pts[i, sl, 0] = gt[i, j, 0] + local[:, 0] * c - local[:, 1] * s
            pts[i, sl, 1] = gt[i, j, 1] + local[:, 0] * s + local[:, 1] * c
            pts[i, sl, 2] = gt[i, j, 2] + local[:, 2]
    return pts, gt


def test_point_targets_and_loss_equal_jax():
    rng = np.random.RandomState(1)
    pts, gt = scene(rng, n_valid=(5, 2))
    cls_l, box_l = tph.assign_point_targets(_t(pts), _t(gt), PointResidualCoder(MEAN_SIZE))
    jcls, jbox = jph.assign_point_targets(jnp.asarray(pts), jnp.asarray(gt),
                                          JPointCoder(mean_size=MEAN_SIZE))
    np.testing.assert_array_equal(cls_l.numpy(), _np(jcls))
    assert (cls_l.numpy() > 0).sum() > 100 and (cls_l.numpy() < 0).sum() > 10
    np.testing.assert_allclose(box_l.numpy(), _np(jbox), rtol=1e-5, atol=1e-5)

    cls_pred = rng.normal(0, 2, (2, 2000, 1)).astype(np.float32)
    box_pred = rng.normal(0, 1, (2, 2000, 8)).astype(np.float32)
    got = tph.point_head_loss(_t(cls_pred), _t(box_pred), cls_l, box_l, num_class=1,
                              code_weights=[1.0] * 8)
    want = jph.point_head_loss(cls_pred, box_pred, jcls, jbox, num_class=1,
                               code_weights=[1.0] * 8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), **TOL)


def jax_draws(key, b, r, s):
    """The uniforms JAX's sample_rois_for_rcnn draws from its key: split per
    scene, then (fg, hard, easy)."""
    out = {"u_fg": [], "u_hard": [], "u_easy": []}
    for k in jax.random.split(key, b):
        k_fg, k_hard, k_easy = jax.random.split(k, 3)
        out["u_fg"].append(np.asarray(jax.random.uniform(k_fg, (r,))))
        out["u_hard"].append(np.asarray(jax.random.uniform(k_hard, (s,))))
        out["u_easy"].append(np.asarray(jax.random.uniform(k_easy, (s,))))
    return {k: torch.from_numpy(np.stack(v)) for k, v in out.items()}


def roi_inputs(rng, case):
    """Proposals around the gt boxes (fg, hard and easy pools), or cases
    that take the sampler's fallbacks: no gt (all easy), all fg, fg and easy
    only (no hard pool)."""
    b, r, m = 2, 96, 8
    gt = np.zeros((b, m, 8), np.float32)
    gt[:, :5, :7] = random_boxes(rng, (b, 5))
    gt[:, :5, 7] = 1
    src = gt[:, rng.randint(0, 5, r), :7]
    jitter = {"mixed": 0.6, "no_gt": 0.6, "all_fg": 0.02, "no_hard": 0.0}[case]
    rois = src + rng.normal(0, jitter, src.shape).astype(np.float32) * [1, 1, 0.3, 0.3, 0.3,
                                                                          0.3, 0.2]
    rois[..., 3:6] = np.abs(rois[..., 3:6]) + 0.5
    if case == "all_fg":  # the gt boxes themselves: no background pool at all
        rois = src.copy()
    if case == "no_gt":
        gt[1] = 0
    if case == "no_hard":
        rois[:, ::2] = random_boxes(rng, (b, r // 2)) + [60, 60, 0, 0, 0, 0, 0]
    scores = rng.normal(0, 1, (b, r)).astype(np.float32)
    labels = np.ones((b, r), np.int32)
    if case != "all_fg":
        labels[:, ::7] = 2  # another class: never matches under SAMPLE_ROI_BY_EACH_CLASS
    return rois.astype(np.float32), scores, labels, gt


@pytest.mark.parametrize("case", ["mixed", "no_gt", "all_fg", "no_hard"])
def test_roi_sampler_with_jax_draws_equals_jax(case):
    rng = np.random.RandomState({"mixed": 2, "no_gt": 3, "all_fg": 4, "no_hard": 5}[case])
    rois, scores, labels, gt = roi_inputs(rng, case)
    key = jax.random.fold_in(jax.random.PRNGKey(666), 7)
    s = TARGET_CFG["ROI_PER_IMAGE"]
    want = jrh.sample_rois_for_rcnn(key, jnp.asarray(rois), jnp.asarray(scores),
                                    jnp.asarray(labels), jnp.asarray(gt), JConfig(TARGET_CFG))
    got = trh.sample_rois_for_rcnn(_t(rois), _t(scores), _t(labels), _t(gt), Config(TARGET_CFG),
                                   jax_draws(key, 2, rois.shape[1], s))
    assert got["rois"].shape == (2, s, 7)
    # the sampled indices: JAX returns the rows, the port also their index
    np.testing.assert_array_equal(
        np.take_along_axis(rois, got["roi_idx"].numpy()[..., None], 1), got["rois"].numpy())
    for k in ("rois", "gt_of_rois", "roi_scores", "roi_labels", "reg_valid_mask",
              "rcnn_cls_labels"):
        np.testing.assert_array_equal(got[k].numpy(), _np(want[k]), err_msg=k)
    # IoU as tests/test_torch_boxes.py holds it (the clip's summation order)
    np.testing.assert_allclose(got["gt_iou_of_rois"].numpy(), _np(want["gt_iou_of_rois"]),
                               atol=1e-5)
    fg = got["reg_valid_mask"].numpy().sum()
    if case == "all_fg":
        assert fg == 2 * s
    elif case == "mixed":
        assert 0 < fg < 2 * s


def test_default_draws_come_from_the_generator():
    rng = np.random.RandomState(6)
    rois, scores, labels, gt = roi_inputs(rng, "mixed")
    args = (_t(rois), _t(scores), _t(labels), _t(gt), Config(TARGET_CFG))
    a = trh.sample_rois_for_rcnn(*args, trh.sampler_draws(2, 96, 128, "cpu",
                                                          torch.Generator().manual_seed(1)))
    b = trh.sample_rois_for_rcnn(*args, trh.sampler_draws(2, 96, 128, "cpu",
                                                          torch.Generator().manual_seed(1)))
    c = trh.sample_rois_for_rcnn(*args, trh.sampler_draws(2, 96, 128, "cpu",
                                                          torch.Generator().manual_seed(2)))
    assert torch.equal(a["roi_idx"], b["roi_idx"]) and not torch.equal(a["roi_idx"], c["roi_idx"])


def test_canonical_transform_and_roi_loss_equal_jax():
    rng = np.random.RandomState(7)
    rois, scores, labels, gt = roi_inputs(rng, "mixed")
    key = jax.random.PRNGKey(3)
    s = TARGET_CFG["ROI_PER_IMAGE"]
    t = trh.sample_rois_for_rcnn(_t(rois), _t(scores), _t(labels), _t(gt), Config(TARGET_CFG),
                                 jax_draws(key, 2, rois.shape[1], s))
    rois_s = t["rois"].numpy()
    rois_s[0, :3, 6] = [-7.0, 3.5, 9.9]  # headings beyond ±2π
    ct = trh.canonical_transform_gt(_t(rois_s), t["gt_of_rois"])
    jct = jrh.canonical_transform_gt(jnp.asarray(rois_s), jnp.asarray(t["gt_of_rois"].numpy()))
    np.testing.assert_allclose(ct.numpy(), _np(jct), rtol=1e-5, atol=2e-6)

    targets = {k: v.numpy() for k, v in t.items()}
    targets.update(gt_of_rois_src=targets["gt_of_rois"], gt_of_rois_ct=_np(jct))
    rcnn_cls = rng.normal(0, 1, (2 * s, 1)).astype(np.float32)
    rcnn_reg = rng.normal(0, 0.3, (2 * s, 7)).astype(np.float32)
    cw = [1.0] * 7
    got = trh.roi_head_loss(_t(rcnn_cls), _t(rcnn_reg), {k: _t(v) for k, v in targets.items()},
                            ResidualCoder(), cw)
    want = jrh.roi_head_loss(jnp.asarray(rcnn_cls), jnp.asarray(rcnn_reg),
                             {k: jnp.asarray(v) for k, v in targets.items()}, JResidualCoder(),
                             cw)
    assert float(got[1]) > 0 and float(got[2]) > 0  # foreground RoIs were sampled
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), **TOL)


def test_focal_loss_gradient_overflows_as_jax_does():
    """The focal loss takes its probability as 1 / (1 + exp(-x)), in JAX as
    here. Below x ≈ -88.72 exp(-x) overflows float32: the loss stays
    finite, but the gradient is inf · 0 = NaN on both sides, at the same
    entries (a diverging run's first non-finite value on the card). Above
    that the gradients agree."""
    logits = np.array([[-100.0], [-88.8], [-88.7], [-30.0], [0.3], [40.0], [100.0]], np.float32)
    targets = np.array([[0.0], [0.0], [0.0], [1.0], [1.0], [0.0], [1.0]], np.float32)
    weights = np.ones(len(logits), np.float32)
    jloss = jnp.sum(jl.sigmoid_focal_loss(jnp.asarray(logits), jnp.asarray(targets),
                                          jnp.asarray(weights)))
    want = np.asarray(jax.grad(lambda x: jnp.sum(jl.sigmoid_focal_loss(
        x, jnp.asarray(targets), jnp.asarray(weights))))(jnp.asarray(logits)))
    x = torch.from_numpy(logits).requires_grad_()
    loss = tl.sigmoid_focal_loss(x, torch.from_numpy(targets), torch.from_numpy(weights)).sum()
    loss.backward()
    got = x.grad.numpy()
    assert np.isfinite(float(jloss)) and np.isfinite(loss.item())
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    overflow = logits[:, 0] < -88.72
    assert overflow.sum() == 2
    np.testing.assert_array_equal(np.isnan(got[:, 0]), overflow)
    np.testing.assert_array_equal(np.isnan(want[:, 0]), overflow)
    np.testing.assert_allclose(got[~overflow], want[~overflow], rtol=1e-6, atol=1e-30)
