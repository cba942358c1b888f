"""PointPillars and SECOND in modest_tpu_torch against the JAX package, whole:
the tiny configs of tests/test_grid_detectors.py (copied below), JAX's
initial weights carried over by ``models/convert.py``, the same toy batch.
One JAX run per model is shared by the module: its train forward, loss,
gradients (``jax.grad``), updated batch statistics, eval forward and
post-processing. Also the weight bridge's coverage and the pcdet loader
(spconv layouts, HeightCompression's channel order) against plain-torch
pcdet-order computations."""
from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modest_tpu.models import grid_detectors as jgd
# imported before any jit: its module constants must not be made under a trace
from modest_tpu.models import sparse_conv as _jsc  # noqa: F401
from modest_tpu.utils.config import Config as JConfig
from modest_tpu_torch.models import build_network
from modest_tpu_torch.models import grid_detectors as gd
from modest_tpu_torch.models.convert import grid_state_dict_from_jax, state_dict_from_pcdet
from modest_tpu_torch.utils.config import Config
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

PCR = [0, -8, -3, 16, 8, 1]
MAX_VOXELS = 512


def pillar_model_cfg():
    return {
        "NAME": "PointPillar",
        "VFE": {"NAME": "PillarVFE", "WITH_DISTANCE": False, "USE_ABSLOTE_XYZ": True,
                "USE_NORM": True, "NUM_FILTERS": [16]},
        "MAP_TO_BEV": {"NAME": "PointPillarScatter", "NUM_BEV_FEATURES": 16},
        "BACKBONE_2D": {"NAME": "BaseBEVBackbone", "LAYER_NUMS": [1, 1],
                        "LAYER_STRIDES": [2, 2], "NUM_FILTERS": [16, 32],
                        "UPSAMPLE_STRIDES": [1, 2], "NUM_UPSAMPLE_FILTERS": [16, 16]},
        "DENSE_HEAD": {
            "NAME": "AnchorHeadSingle", "CLASS_AGNOSTIC": False,
            "USE_DIRECTION_CLASSIFIER": True, "DIR_OFFSET": 0.78539,
            "DIR_LIMIT_OFFSET": 0.0, "NUM_DIR_BINS": 2,
            "ANCHOR_GENERATOR_CONFIG": [{
                "class_name": "Dynamic", "anchor_sizes": [[2.0, 1.0, 1.7]],
                "anchor_rotations": [0, 1.57], "anchor_bottom_heights": [-1.6],
                "align_center": False, "feature_map_stride": 2,
                "matched_threshold": 0.5, "unmatched_threshold": 0.35,
            }],
            "TARGET_ASSIGNER_CONFIG": {"NAME": "AxisAlignedTargetAssigner",
                                       "POS_FRACTION": -1.0, "SAMPLE_SIZE": 512,
                                       "NORM_BY_NUM_EXAMPLES": False,
                                       "MATCH_HEIGHT": False,
                                       "BOX_CODER": "ResidualCoder"},
            "LOSS_CONFIG": {"LOSS_WEIGHTS": {"cls_weight": 1.0, "loc_weight": 2.0,
                                             "dir_weight": 0.2,
                                             "code_weights": [1.0] * 7}},
        },
        "POST_PROCESSING": {"RECALL_THRESH_LIST": [0.3, 0.5, 0.7], "SCORE_THRESH": 0.1,
                            "OUTPUT_RAW_SCORE": False, "EVAL_METRIC": "kitti",
                            "NMS_CONFIG": {"MULTI_CLASSES_NMS": False,
                                           "NMS_TYPE": "nms_gpu", "NMS_THRESH": 0.01,
                                           "NMS_PRE_MAXSIZE": 256,
                                           "NMS_POST_MAXSIZE": 32}},
    }


def second_model_cfg():
    cfg = pillar_model_cfg()
    cfg["NAME"] = "SECONDNet"
    cfg["VFE"] = {"NAME": "MeanVFE"}
    cfg["MAP_TO_BEV"] = {"NAME": "HeightCompression", "NUM_BEV_FEATURES": 256}
    cfg["DENSE_HEAD"]["ANCHOR_GENERATOR_CONFIG"][0]["feature_map_stride"] = 8
    cfg["BACKBONE_2D"] = {"NAME": "BaseBEVBackbone", "LAYER_NUMS": [1, 1],
                          "LAYER_STRIDES": [1, 2], "NUM_FILTERS": [32, 64],
                          "UPSAMPLE_STRIDES": [1, 2], "NUM_UPSAMPLE_FILTERS": [32, 32]}
    return cfg


GEOMETRY = {"pillar": ([0.5, 0.5, 4.0], (32, 32, 1), (8.0, 0.0)),
            # z deep enough for the 8x z-downsampling; the gt on a stride-8 anchor site
            "second": ([0.5, 0.5, 0.125], (32, 32, 32), (16 / 3, -8 / 3))}


def toy_batch(seed, gt_xy, n=512, b=2):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(0, 1, (b, n, 4)).astype(np.float32)
    pts[..., 0] *= 16
    pts[..., 1] = (pts[..., 1] - 0.5) * 16
    pts[..., 2] = pts[..., 2] * 4 - 3
    gt = np.zeros((b, 3, 8), np.float32)
    gt[:, 0, :7] = [gt_xy[0], gt_xy[1], -0.75, 2, 1, 1.7, 0.0]
    gt[:, 0, 7] = 1
    gt[1, 1, :7] = [gt_xy[0] + 5.3, gt_xy[1] + 2.7, -0.8, 3.5, 1.6, 1.5, 1.2]
    gt[1, 1, 7] = 1
    return pts, gt


def geometry(which):
    vs, gs, _ = GEOMETRY[which]
    return types.SimpleNamespace(point_cloud_range=np.asarray(PCR, np.float32), voxel_size=vs,
                                 grid_size=np.asarray(gs))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, prefix + (key,)).items()}
    return {prefix: np.asarray(tree)}


@pytest.fixture(scope="module", params=["pillar", "second"])
def pair(request):
    which = request.param
    cfg_dict = pillar_model_cfg() if which == "pillar" else second_model_cfg()
    vs, gs, gt_xy = GEOMETRY[which]
    jcfg = JConfig(cfg_dict)
    jmodel = jgd.GridDetector(model_cfg=jcfg, num_class=1, point_cloud_range=PCR,
                              voxel_size=vs, grid_size=gs)
    pts, gt = toy_batch(0, gt_xy)
    variables = jax.jit(lambda key, p, g: jmodel.init(key, p, g, train=True,
                                                      max_voxels=MAX_VOXELS))(
        jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(gt))
    params, stats0 = variables["params"], variables["batch_stats"]

    def loss_fn(p):
        out, mut = jmodel.apply({"params": p, "batch_stats": stats0}, jnp.asarray(pts),
                                jnp.asarray(gt), train=True, max_voxels=MAX_VOXELS,
                                mutable=["batch_stats"])
        loss, metrics = jgd.grid_detector_loss(out, jcfg)
        return loss, (out, mut["batch_stats"], metrics)

    (loss, (out, stats1, metrics)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    eval_out = jax.jit(lambda v, p: jmodel.apply(v, p, train=False, max_voxels=MAX_VOXELS))(
        {"params": params, "batch_stats": stats1}, jnp.asarray(pts))

    port = build_network(Config(cfg_dict), 1, device="cpu", dataset=geometry(which))
    shapes = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    port.load_state_dict(grid_state_dict_from_jax(params, stats0, jcfg))
    return types.SimpleNamespace(
        which=which, cfg=Config(cfg_dict), jcfg=jcfg, port=port, pts=pts, gt=gt, shapes=shapes,
        params=params, stats0=stats0, stats1=stats1, grads=grads, loss=float(loss),
        metrics={k: float(v) for k, v in metrics.items()},
        out=jax.tree_util.tree_map(np.asarray, out),
        eval_out=jax.tree_util.tree_map(np.asarray, eval_out))


def _port_train(pair):
    port = pair.port
    port.load_state_dict(grid_state_dict_from_jax(pair.params, pair.stats0, pair.jcfg))
    port.train()
    for p in port.parameters():
        p.grad = None
    out = port(torch.from_numpy(pair.pts), torch.from_numpy(pair.gt), max_voxels=MAX_VOXELS)
    loss, metrics = gd.grid_detector_loss(out, pair.cfg, 1)
    loss.backward()
    return out, loss, metrics


def test_bridge_covers_every_leaf(pair):
    """Every parameter and batch statistic of the port comes from the JAX
    trees, and every JAX leaf lands somewhere (counts match)."""
    sd = grid_state_dict_from_jax(pair.params, pair.stats0, pair.jcfg)
    assert set(sd) == set(pair.shapes)
    for k, v in sd.items():
        assert tuple(v.shape) == pair.shapes[k], k
    n_jax = sum(v.size for v in _flat(pair.params).values()) + sum(
        v.size for v in _flat(pair.stats0).values())
    n_port = sum(v.numel() for k, v in sd.items() if not k.endswith("num_batches_tracked"))
    assert n_port == n_jax


def test_eval_forward_and_boxes_match_jax(pair):
    """The eval outputs within rtol 1e-4, atol 1e-5, and the final boxes
    1:1 with those of JAX's outputs (``grid_post_process`` itself is held
    to the JAX package's in tests/test_torch_grid_ops.py)."""
    port = pair.port
    port.load_state_dict(grid_state_dict_from_jax(pair.params, pair.stats1, pair.jcfg))
    port.eval()
    with torch.no_grad():
        out = port(torch.from_numpy(pair.pts), max_voxels=MAX_VOXELS)
        final = gd.grid_post_process(out, pair.cfg.POST_PROCESSING)
    for key in ("cls_preds", "box_preds", "dir_cls_preds", "batch_cls_preds",
                "batch_box_preds"):
        np.testing.assert_allclose(out[key].numpy(), pair.eval_out[key], rtol=1e-4, atol=1e-5,
                                   err_msg=key)
    np.testing.assert_array_equal(out["anchors"].numpy(), pair.eval_out["anchors"])
    with torch.no_grad():
        want = gd.grid_post_process({k: torch.from_numpy(np.array(pair.eval_out[k])) for k in
                                     ("batch_cls_preds", "batch_box_preds")},
                                    pair.cfg.POST_PROCESSING)
    for i in range(len(pair.pts)):
        v, jv = final["valid"][i].numpy(), want["valid"][i].numpy()
        assert v.sum() == jv.sum() > 0
        np.testing.assert_allclose(final["boxes"][i].numpy()[v], want["boxes"][i].numpy()[jv],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(final["scores"][i].numpy()[v], want["scores"][i].numpy()[jv],
                                   rtol=1e-4, atol=1e-5)


def test_train_forward_targets_loss_and_statistics_match_jax(pair):
    out, loss, metrics = _port_train(pair)
    np.testing.assert_array_equal(out["box_cls_labels"].numpy(), pair.out["box_cls_labels"])
    assert (out["box_cls_labels"] > 0).sum() > 0
    np.testing.assert_allclose(out["box_reg_targets"].numpy(), pair.out["box_reg_targets"],
                               rtol=1e-6, atol=1e-6)
    for key in ("cls_preds", "box_preds", "dir_cls_preds"):
        np.testing.assert_allclose(out[key].detach().numpy(), pair.out[key], rtol=1e-4,
                                   atol=1e-5, err_msg=key)
    for k, v in metrics.items():
        np.testing.assert_allclose(v.item(), pair.metrics[k], rtol=1e-4, err_msg=k)
    # the running statistics the train forward left behind
    stats = grid_state_dict_from_jax(pair.params, pair.stats1, pair.jcfg)
    own = pair.port.state_dict()
    checked = 0
    for k, v in stats.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(own[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
            checked += 1
    assert checked >= 6


def test_loss_function_matches_jax_on_the_same_outputs(pair):
    """grid_detector_loss alone, fed JAX's train outputs: rtol 1e-5."""
    out = {k: torch.from_numpy(np.array(v)) for k, v in pair.out.items()}
    _, metrics = gd.grid_detector_loss(out, pair.cfg, 1)
    _, want = jax.jit(lambda o: jgd.grid_detector_loss(o, pair.jcfg))(
        jax.tree_util.tree_map(jnp.asarray, pair.out))
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), float(want[k]), rtol=1e-5, err_msg=k)


def test_gradients_match_jax_grad(pair):
    """Every parameter's gradient within 1e-4 of its JAX gradient's norm
    (the PFN's through the segment max included)."""
    _port_train(pair)
    want = grid_state_dict_from_jax(pair.grads, pair.stats0, pair.jcfg)
    compared = 0
    for name, p in pair.port.named_parameters():
        g, w = p.grad.numpy(), want[name].numpy()
        scale = max(float(np.linalg.norm(w)), 1e-12)
        assert float(np.linalg.norm(g - w)) <= 1e-4 * scale, (name, np.linalg.norm(g - w), scale)
        compared += 1
    assert compared == len(list(pair.port.parameters()))


def test_build_network_takes_the_data_geometry_and_refuses_unported_heads():
    """The geometry is required; the grouped head (AnchorHeadMulti) and the
    ATSS assigner, once refused, build now; a target assigner JAX does not
    know is refused, as JAX refuses it."""
    from modest_tpu_torch.models.anchor_head_multi import AnchorHeadMulti

    cfg = Config(pillar_model_cfg())
    with pytest.raises(ValueError, match="geometry"):
        build_network(cfg, 1, device="cpu")
    model = build_network(cfg, 1, device="cpu", dataset=geometry("pillar"))
    assert model.anchors.shape == (16 * 16 * 2, 7) and not model.training
    multi = Config(second_model_cfg())
    multi.DENSE_HEAD.NAME = "AnchorHeadMulti"
    with_names = types.SimpleNamespace(**vars(geometry("second")), class_names=["Dynamic"])
    model = build_network(multi, 1, device="cpu", dataset=with_names)
    assert isinstance(model.dense_head, AnchorHeadMulti)
    atss = Config(second_model_cfg())
    atss.DENSE_HEAD.TARGET_ASSIGNER_CONFIG.NAME = "ATSS"
    assert build_network(atss, 1, device="cpu", dataset=geometry("second")).assigner == "ATSS"
    bad = Config(second_model_cfg())
    bad.DENSE_HEAD.TARGET_ASSIGNER_CONFIG.NAME = "HungarianAssigner"
    with pytest.raises(NotImplementedError, match="HungarianAssigner"):
        build_network(bad, 1, device="cpu", dataset=geometry("second"))


# --- the pcdet loader: layouts a pcdet checkpoint stores ------------------------


def test_pcdet_sparse_weights_load_in_either_spconv_layout():
    """A SubM conv and a strided conv loaded from spconv 1.x and 2.x
    layouts equal a dense torch Conv3d (pcdet's sparse convs correlate, no
    flip) at the active sites."""
    from modest_tpu_torch.models import sparse_conv as sc

    torch.manual_seed(0)
    shape = (7, 9, 10)
    dense_in = torch.zeros(1, 4, *shape)
    active = torch.rand(shape) < 0.2
    dense_in[0, :, active] = torch.randn(4, int(active.sum()))
    keys = torch.nonzero(active.reshape(-1))[:, 0][None]
    v = keys.shape[1]
    coords = sc.key_to_zyx(keys, shape[1], shape[2])
    valid = torch.ones(1, v, dtype=torch.bool)
    feats = dense_in[0].reshape(4, -1)[:, keys[0]].T[None].contiguous()
    w1 = torch.randn(3, 3, 3, 4, 16)  # spconv 1.x (kz, ky, kx, in, out)
    bn = {"backbone_3d.conv_input.1.weight": torch.ones(16)}
    model = types.SimpleNamespace(model_cfg={"NAME": "SECONDNet"})
    for layout, w in (("spconv1", w1), ("spconv2", w1.permute(4, 0, 1, 2, 3))):
        sd = state_dict_from_pcdet({"backbone_3d.conv_input.0.weight": w, **bn}, model)
        conv = sc.SubMConv3d(4, 16)
        conv.weight.data.copy_(sd["backbone_3d.conv_input.0.weight"])
        rows = sc.neighbor_index(keys, valid, coords, shape, sc.OFFSETS3)
        got = conv(feats, rows, valid)[0]
        ref = torch.nn.functional.conv3d(dense_in, w1.permute(4, 3, 0, 1, 2), padding=1)
        want = ref[0].reshape(16, -1)[:, keys[0]].T
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5, msg=layout)
    # a strided opener: its output sites are the dense conv's non-empty windows
    w = torch.randn(3, 3, 3, 4, 8)
    conv = sc.SparseConv3d(4, 8, (2, 2, 2), (1, 1, 1))
    conv.weight.data.copy_(w)
    s_out = sc.down_shape(shape, (2, 2, 2), (1, 1, 1))
    y, oc, ok, ov = conv(feats, coords, keys, valid, shape, s_out)
    ref = torch.nn.functional.conv3d(dense_in, w.permute(4, 3, 0, 1, 2), stride=2, padding=1)
    touched = torch.nn.functional.conv3d(active[None, None].float(), torch.ones(1, 1, 3, 3, 3),
                                         stride=2, padding=1)[0, 0] > 0
    assert int(ov.sum()) == int(touched.sum())
    sites = ok[0][ov[0]]
    torch.testing.assert_close(y[0][ov[0]], ref[0].reshape(8, -1)[:, sites].T, rtol=1e-5,
                               atol=1e-5)


def test_pcdet_height_compression_order_loads_into_the_port_order():
    """pcdet's HeightCompression views (N, C, D, H, W) as (N, C·D, H, W);
    the port's map orders channels z·C + c. A pcdet first BEV conv loaded
    through ``state_dict_from_pcdet`` gives the port's map the output pcdet's
    conv gives pcdet's."""
    from modest_tpu_torch.models import sparse_conv as sc

    torch.manual_seed(1)
    c, d, h, w = 128, 2, 5, 6
    dense = torch.randn(1, c, d, h, w)  # pcdet's dense tensor after conv_out
    pcdet_bev = dense.view(1, c * d, h, w)
    weight = torch.randn(32, c * d, 3, 3)
    model = build_network(Config(second_model_cfg()), 1, device="cpu",
                          dataset=geometry("second"))
    # a SECOND whose BEV input has D = 2 slices of 128 channels
    model.backbone_3d.conv_out[0].weight.data = torch.zeros(3, 1, 1, 64, c)
    sd = state_dict_from_pcdet({"backbone_2d.blocks.0.1.weight": weight}, model)
    feats = dense[0].permute(1, 2, 3, 0).reshape(1, -1, c)
    keys = torch.arange(d * h * w)[None]
    port_bev = sc.height_compress(feats, keys, torch.ones_like(keys, dtype=torch.bool), (d, h, w))
    want = torch.nn.functional.conv2d(pcdet_bev, weight, padding=1)
    got = torch.nn.functional.conv2d(port_bev, sd["backbone_2d.blocks.0.1.weight"], padding=1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert not torch.equal(port_bev, pcdet_bev)  # the orders do differ


def test_a_pcdet_pointpillar_checkpoint_loads_by_key_and_runs_as_pcdet(tmp_path):
    """pcdet's PointPillar keys and layouts are the port's: a pcdet-style
    checkpoint of random tensors loads whole through ``--pretrained_model``'s
    loader, and the BEV backbone and head equal a plain torch pcdet
    BaseBEVBackbone + AnchorHeadSingle built from those tensors."""
    from modest_tpu_torch.train.checkpoint import load_params_partial

    cfg = Config(pillar_model_cfg())
    model = build_network(cfg, 1, device="cpu", dataset=geometry("pillar"), seed=3)
    gen = torch.Generator().manual_seed(4)
    state = {k: (torch.rand(v.shape, generator=gen) + 0.5 if k.endswith("running_var")
                 else torch.randn(v.shape, generator=gen) * 0.3)
             if v.is_floating_point() else v for k, v in model.state_dict().items()}
    torch.save({"epoch": 80, "it": 0, "model_state": state, "version": "pcdet+0.3.0"},
               tmp_path / "pcdet.pth")
    n_loaded, n_skipped = load_params_partial(model, tmp_path / "pcdet.pth")
    assert (n_loaded, n_skipped) == (len(state), 0)

    # plain pcdet: blocks = ZeroPad2d, Conv2d, BN, ReLU, [Conv2d, BN, ReLU]*n; deblocks =
    # ConvTranspose2d, BN, ReLU; the head's 1x1 convs permuted to (B, H, W, A·C)
    nn = torch.nn
    bb = cfg.BACKBONE_2D
    blocks, deblocks, c_in = [], [], 16
    for i, n in enumerate(bb.LAYER_NUMS):
        nf = bb.NUM_FILTERS[i]
        layers = [nn.ZeroPad2d(1), nn.Conv2d(c_in, nf, 3, bb.LAYER_STRIDES[i], bias=False),
                  nn.BatchNorm2d(nf, eps=1e-3), nn.ReLU()]
        for _ in range(n):
            layers += [nn.Conv2d(nf, nf, 3, padding=1, bias=False), nn.BatchNorm2d(nf, eps=1e-3),
                       nn.ReLU()]
        blocks.append(nn.Sequential(*layers))
        s = bb.UPSAMPLE_STRIDES[i]
        deblocks.append(nn.Sequential(nn.ConvTranspose2d(nf, bb.NUM_UPSAMPLE_FILTERS[i], s, s,
                                                         bias=False),
                                      nn.BatchNorm2d(bb.NUM_UPSAMPLE_FILTERS[i], eps=1e-3),
                                      nn.ReLU()))
        c_in = nf
    ref = nn.ModuleDict({"blocks": nn.ModuleList(blocks), "deblocks": nn.ModuleList(deblocks)})
    ref.load_state_dict({k[len("backbone_2d."):]: v for k, v in state.items()
                         if k.startswith("backbone_2d.")})
    conv_cls = nn.Conv2d(32, 2, 1)
    conv_cls.load_state_dict({"weight": state["dense_head.conv_cls.weight"],
                              "bias": state["dense_head.conv_cls.bias"]})
    ref.eval()
    x = torch.rand(2, 16, 32, 32)
    with torch.no_grad():
        ups, y = [], x
        for blk, de in zip(ref["blocks"], ref["deblocks"]):
            y = blk(y)
            ups.append(de(y))
        want = conv_cls(torch.cat(ups, 1)).permute(0, 2, 3, 1).reshape(2, -1, 1)
        got = model.dense_head(model.backbone_2d(x))[0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
