"""Reference .pth checkpoint conversion (train/torch_convert.py).

Builds the reference's OWN torch PointRCNN submodules (random weights, CUDA
exts stubbed) for the flagship config, converts their state_dict into our
flax trees, and asserts (a) full coverage — every one of our param /
batch_stats leaves receives a checkpoint tensor — and (b) numerical forward
equality of every converted stack (1x1-conv/BN/ReLU sequentials vs our
channel-last SharedMLP/FCHead) in eval mode.
"""
import sys
import types
from pathlib import Path

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

pytestmark = pytest.mark.slow

REF_PCDET = Path("/root/reference/downstream/OpenPCDet")


@pytest.fixture(scope="module")
def ref_modules():
    sys.path.insert(0, str(REF_PCDET))
    ver = types.ModuleType("pcdet.version")
    ver.__version__ = "0.3.0+ref"
    sys.modules.setdefault("pcdet.version", ver)
    for ext in ("pcdet.ops.roiaware_pool3d.roiaware_pool3d_cuda",
                "pcdet.ops.iou3d_nms.iou3d_nms_cuda",
                "pcdet.ops.pointnet2.pointnet2_batch.pointnet2_batch_cuda",
                "pcdet.ops.pointnet2.pointnet2_stack.pointnet2_stack_cuda",
                "pcdet.ops.roipoint_pool3d.roipoint_pool3d_cuda",
                "torchvision", "kornia"):
        sys.modules.setdefault(ext, types.ModuleType(ext))
    if "spconv" not in sys.modules:
        sp = types.ModuleType("spconv")
        for n in ("SparseModule", "SparseSequential", "SubMConv3d",
                  "SparseConv3d", "SparseConvTensor", "SparseInverseConv3d"):
            setattr(sp, n, type(n, (), {}))
        sys.modules["spconv"] = sp
    if "easydict" not in sys.modules:
        ed = types.ModuleType("easydict")

        class EasyDict(dict):
            def __init__(self, d=None):
                super().__init__()
                for k, v in (d or {}).items():
                    if isinstance(v, dict):
                        v = EasyDict(v)
                    elif isinstance(v, list):
                        v = [EasyDict(x) if isinstance(x, dict) else x for x in v]
                    self[k] = v

            def __getattr__(self, k):
                try:
                    return self[k]
                except KeyError as e:
                    raise AttributeError(k) from e

            __setattr__ = dict.__setitem__

        ed.EasyDict = EasyDict
        sys.modules["easydict"] = ed

    import torch

    # reference model code calls .cuda() unconditionally in places
    torch.Tensor.cuda = lambda self, *a, **k: self
    torch.nn.Module.cuda = lambda self, *a, **k: self
    torch.manual_seed(0)
    from easydict import EasyDict

    import yaml

    cfg = EasyDict(yaml.safe_load(
        open("configs/models/lyft_models/pointrcnn_dynamic_obj.yaml"))["MODEL"])
    from pcdet.models.backbones_3d.pointnet2_backbone import PointNet2MSG
    from pcdet.models.dense_heads.point_head_box import PointHeadBox
    from pcdet.models.roi_heads.pointrcnn_head import PointRCNNHead

    bb = PointNet2MSG(model_cfg=cfg.BACKBONE_3D, input_channels=4).eval()
    ph = PointHeadBox(model_cfg=cfg.POINT_HEAD, num_class=1, input_channels=128,
                      predict_boxes_when_training=True).eval()
    rh = PointRCNNHead(model_cfg=cfg.ROI_HEAD, input_channels=128, num_class=1).eval()
    # non-trivial running stats so eval-mode BN actually tests the transfer
    with torch.no_grad():
        for m in list(bb.modules()) + list(ph.modules()) + list(rh.modules()):
            if hasattr(m, "running_mean") and m.running_mean is not None:
                m.running_mean.uniform_(-0.3, 0.3)
                m.running_var.uniform_(0.5, 1.5)
    state = {}
    for prefix, m in (("backbone_3d", bb), ("point_head", ph), ("roi_head", rh)):
        for k, v in m.state_dict().items():
            state[f"{prefix}.{k}"] = v
    yield types.SimpleNamespace(backbone=bb, point_head=ph, roi_head=rh,
                                model_state=state)
    sys.path.remove(str(REF_PCDET))


@pytest.fixture(scope="module")
def converted(ref_modules):
    import jax
    import jax.numpy as jnp

    from modest_tpu.models.pointrcnn import PointRCNN
    from modest_tpu.train.torch_convert import convert_pointrcnn_state
    from modest_tpu.utils.config import cfg_from_yaml_file

    cfg = cfg_from_yaml_file("configs/models/lyft_models/pointrcnn_dynamic_obj.yaml")
    model = PointRCNN(model_cfg=cfg.MODEL, num_class=1)
    pts = jnp.asarray(np.random.RandomState(0).randn(1, 512, 4).astype(np.float32))
    var = model.init(
        {"params": jax.random.PRNGKey(0), "sampler": jax.random.PRNGKey(1)},
        pts, jnp.zeros((1, 2, 8), jnp.float32), train=True)
    params, stats, report = convert_pointrcnn_state(
        ref_modules.model_state, var["params"], var["batch_stats"])
    return types.SimpleNamespace(params=params, stats=stats, report=report,
                                 init=var)


def _leaf_paths(tree, prefix=()):
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _leaf_paths(v, prefix + (k,))
        else:
            out.append("/".join(prefix + (k,)))
    return out


def test_full_coverage(converted):
    """Every flax leaf gets a checkpoint tensor; nothing foreign skipped."""
    import numpy as np

    want = set(_leaf_paths(converted.params)) | set(_leaf_paths(converted.stats))
    got = set(converted.report.converted)
    missing = want - got
    assert not missing, f"unconverted leaves: {sorted(missing)[:10]}"
    assert not converted.report.skipped_ref


def _ours_apply(module, params, stats, x, subpath):
    """Apply a flax module with the converted subtree at subpath."""
    node_p, node_s = params, stats
    for p in subpath:
        node_p = node_p[p]
        node_s = node_s.get(p, {}) if isinstance(node_s, dict) else {}
    import jax.numpy as jnp

    return np.asarray(module.apply(
        {"params": node_p, "batch_stats": node_s}, jnp.asarray(x), train=False))


def test_shared_mlp_forward_equality(ref_modules, converted, rng):
    """Backbone SA mlp stack: torch Conv2d/BN2d/ReLU ≡ our SharedMLP."""
    import torch

    from modest_tpu.models.layers import SharedMLP

    seq = ref_modules.backbone.SA_modules[0].mlps[0]  # 4→16→16→32
    x = rng.randn(2, 16, 8, 4).astype(np.float32)  # (B, npoint, ns, C)
    with torch.no_grad():
        ref_out = seq(torch.from_numpy(np.ascontiguousarray(
            x.transpose(0, 3, 1, 2)))).numpy().transpose(0, 2, 3, 1)
    ours = _ours_apply(SharedMLP((16, 16, 32)), converted.params,
                       converted.stats, x,
                       ("backbone", "SAModuleMSG_0", "SharedMLP_0"))
    np.testing.assert_allclose(ours, ref_out, atol=2e-5)


def test_fp_mlp_forward_equality(ref_modules, converted, rng):
    """Deepest FP mlp (reference index 3 ≡ our FPModule_0)."""
    import torch

    from modest_tpu.models.layers import SharedMLP

    seq = ref_modules.backbone.FP_modules[3].mlp  # in 1536 → 512 → 512
    x = rng.randn(2, 64, 1, 1536).astype(np.float32)
    with torch.no_grad():
        ref_out = seq(torch.from_numpy(np.ascontiguousarray(
            x.transpose(0, 3, 1, 2)))).numpy().transpose(0, 2, 3, 1)
    ours = _ours_apply(SharedMLP((512, 512)), converted.params,
                       converted.stats, x,
                       ("backbone", "FPModule_0", "SharedMLP_0"))
    np.testing.assert_allclose(ours, ref_out, atol=2e-4)


def test_point_head_forward_equality(ref_modules, converted, rng):
    """point_head box_layers (Linear/BN1d, final biased Linear) ≡ FCHead."""
    import torch

    from modest_tpu.models.layers import FCHead

    seq = ref_modules.point_head.box_layers
    x = rng.randn(64, 128).astype(np.float32)
    with torch.no_grad():
        ref_out = seq(torch.from_numpy(x)).numpy()
    ours = _ours_apply(FCHead(hidden=(256, 256), out=8), converted.params,
                       converted.stats, x, ("point_head", "FCHead_1"))
    np.testing.assert_allclose(ours, ref_out, atol=2e-5)


def test_roi_head_forward_equality(ref_modules, converted, rng):
    """roi_head cls_layers (Conv1d/BN1d/Dropout) ≡ FCHead in eval mode."""
    import torch

    from modest_tpu.models.layers import FCHead

    seq = ref_modules.roi_head.cls_layers
    x = rng.randn(6, 512).astype(np.float32)  # (rois, C)
    with torch.no_grad():
        ref_out = seq(torch.from_numpy(x[:, :, None])).numpy()[:, :, 0]
    ours = _ours_apply(FCHead(hidden=(256, 256), out=1), converted.params,
                       converted.stats, x, ("roi_head", "FCHead_0"))
    np.testing.assert_allclose(ours, ref_out, atol=2e-5)


def test_xyz_up_layer_forward_equality(ref_modules, converted, rng):
    """xyz_up_layer: biased Conv2d+ReLU pairs, no BN ≡ SharedMLP(use_bn=False)."""
    import torch

    from modest_tpu.models.layers import SharedMLP

    seq = ref_modules.roi_head.xyz_up_layer
    x = rng.randn(3, 128, 16, 5).astype(np.float32)
    with torch.no_grad():
        ref_out = seq(torch.from_numpy(np.ascontiguousarray(
            x.transpose(0, 3, 1, 2)))).numpy().transpose(0, 2, 3, 1)
    ours = _ours_apply(SharedMLP((128, 128), use_bn=False), converted.params,
                       converted.stats, x, ("roi_head", "SharedMLP_0"))
    np.testing.assert_allclose(ours, ref_out, atol=2e-5)


@pytest.fixture(scope="module")
def pillar_ref(ref_modules):  # ref_modules installs the import stubs
    import torch
    import yaml
    from easydict import EasyDict

    torch.manual_seed(1)
    cfg = EasyDict(yaml.safe_load(
        open("configs/models/lyft_models/pointpillar_dynamic_obj.yaml"))["MODEL"])
    from pcdet.models.backbones_2d.base_bev_backbone import BaseBEVBackbone
    from pcdet.models.backbones_3d.vfe.pillar_vfe import PillarVFE

    vfe = PillarVFE(model_cfg=cfg.VFE, num_point_features=4,
                    voxel_size=[0.16, 0.16, 4.0],
                    point_cloud_range=[0, -39.68, -3, 69.12, 39.68, 1]).eval()
    bb2 = BaseBEVBackbone(model_cfg=cfg.BACKBONE_2D, input_channels=64).eval()
    head = torch.nn.ModuleDict({
        "conv_cls": torch.nn.Conv2d(384, 2, 1),
        "conv_box": torch.nn.Conv2d(384, 14, 1),
        "conv_dir_cls": torch.nn.Conv2d(384, 4, 1),
    }).eval()
    with torch.no_grad():
        for m in list(vfe.modules()) + list(bb2.modules()):
            if hasattr(m, "running_mean") and m.running_mean is not None:
                m.running_mean.uniform_(-0.3, 0.3)
                m.running_var.uniform_(0.5, 1.5)
    state = {}
    for prefix, m in (("vfe", vfe), ("backbone_2d", bb2)):
        for k, v in m.state_dict().items():
            state[f"{prefix}.{k}"] = v
    for name, m in head.items():
        state[f"dense_head.{name}.weight"] = m.weight
        state[f"dense_head.{name}.bias"] = m.bias
    return types.SimpleNamespace(vfe=vfe, backbone_2d=bb2, model_state=state)


@pytest.fixture(scope="module")
def pillar_converted(pillar_ref):
    import jax
    import jax.numpy as jnp

    from modest_tpu.models import build_network
    from modest_tpu.train.torch_convert import convert_torch_state
    from modest_tpu.utils.config import cfg_from_yaml_file

    cfg = cfg_from_yaml_file("configs/models/lyft_models/pointpillar_dynamic_obj.yaml")
    pcr = np.array(cfg.DATA_CONFIG.POINT_CLOUD_RANGE, np.float32)
    vs = [0.16, 0.16, 4.0]

    class DS:
        point_cloud_range = pcr
        voxel_size = vs
        grid_size = np.round((pcr[3:6] - pcr[0:3]) / np.array(vs)).astype(np.int64)
        class_names = cfg.CLASS_NAMES

    model = build_network(cfg.MODEL, num_class=1, dataset=DS)
    pts = jnp.asarray(
        np.random.RandomState(0).uniform(0, 30, (1, 1024, 4)).astype(np.float32))
    var = model.init(
        {"params": jax.random.PRNGKey(0), "sampler": jax.random.PRNGKey(1)},
        pts, jnp.zeros((1, 2, 8), jnp.float32), train=True)
    params, stats, report = convert_torch_state(
        pillar_ref.model_state, var["params"], var["batch_stats"])
    return types.SimpleNamespace(params=params, stats=stats, report=report)


def test_pillar_full_coverage(pillar_converted):
    want = set(_leaf_paths(pillar_converted.params)) | set(
        _leaf_paths(pillar_converted.stats))
    got = set(pillar_converted.report.converted)
    missing = want - got
    assert not missing, f"unconverted leaves: {sorted(missing)[:10]}"
    assert not pillar_converted.report.skipped_ref


def test_pillar_bev_backbone_forward_equality(pillar_ref, pillar_converted, rng):
    """Full BaseBEVBackbone (3 blocks + 3 deblocks, strided convs +
    transposed upsampling) ≡ our BEVBackbone on converted weights."""
    import torch

    from modest_tpu.models.grid_detectors import BEVBackbone

    x = rng.randn(1, 64, 32, 32).astype(np.float32)
    with torch.no_grad():
        ref_out = pillar_ref.backbone_2d(
            {"spatial_features": torch.from_numpy(x)}
        )["spatial_features_2d"].numpy().transpose(0, 2, 3, 1)
    ours = _ours_apply(
        BEVBackbone(layer_nums=(3, 5, 5), layer_strides=(2, 2, 2),
                    num_filters=(64, 128, 256), upsample_strides=(1, 2, 4),
                    num_upsample_filters=(128, 128, 128)),
        pillar_converted.params, pillar_converted.stats,
        x.transpose(0, 2, 3, 1), ("backbone_2d",))
    np.testing.assert_allclose(ours, ref_out, atol=3e-4)


def test_pillar_pfn_forward_equality(pillar_ref, pillar_converted, rng):
    """PFN Linear+BN1d (eval) ≡ our Dense + MaskedBatchNorm math."""
    import torch

    p = pillar_converted.params["vfe"]
    s = pillar_converted.stats["vfe"]
    x = rng.randn(40, 10).astype(np.float32)
    lin = pillar_ref.vfe.pfn_layers[0].linear
    norm = pillar_ref.vfe.pfn_layers[0].norm
    with torch.no_grad():
        ref_out = norm(lin(torch.from_numpy(x))).numpy()
    z = x @ np.asarray(p["Dense_0"]["kernel"])
    z = (z - np.asarray(s["MaskedBatchNorm_0"]["mean"])) / np.sqrt(
        np.asarray(s["MaskedBatchNorm_0"]["var"]) + 1e-3)
    z = z * np.asarray(p["MaskedBatchNorm_0"]["scale"]) + np.asarray(
        p["MaskedBatchNorm_0"]["bias"])
    np.testing.assert_allclose(z, ref_out, atol=2e-5)


def _synth_second_state(rng):
    """A SECOND model_state with the reference's key names and spconv-1.x
    weight layout (kz, ky, kx, in, out) — spconv itself can't run here, so
    the tensors are synthesized; the layout is validated against a dense
    torch Conv3d oracle below."""
    import torch

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    def bn(prefix, c, state):
        state[f"{prefix}.weight"] = t(c).abs() + 0.5
        state[f"{prefix}.bias"] = t(c)
        state[f"{prefix}.running_mean"] = t(c) * 0.1
        state[f"{prefix}.running_var"] = t(c).abs() + 0.5

    s = {}
    s["backbone_3d.conv_input.0.weight"] = t(3, 3, 3, 4, 16)
    bn("backbone_3d.conv_input.1", 16, s)
    s["backbone_3d.conv1.0.0.weight"] = t(3, 3, 3, 16, 16)
    bn("backbone_3d.conv1.0.1", 16, s)
    chans = {2: (16, 32), 3: (32, 64), 4: (64, 64)}
    for st, (ci, co) in chans.items():
        s[f"backbone_3d.conv{st}.0.0.weight"] = t(3, 3, 3, ci, co)
        bn(f"backbone_3d.conv{st}.0.1", co, s)
        for sub in (1, 2):
            s[f"backbone_3d.conv{st}.{sub}.0.weight"] = t(3, 3, 3, co, co)
            bn(f"backbone_3d.conv{st}.{sub}.1", co, s)
    s["backbone_3d.conv_out.0.weight"] = t(3, 1, 1, 64, 128)
    bn("backbone_3d.conv_out.1", 128, s)
    # BEV backbone (second_dynamic_obj: layer_nums [5,5], strides [1,2],
    # filters [128,256], up [1,2] → [256,256])
    blocks = {0: (256, 128, 5, 1), 1: (128, 256, 5, 2)}
    for blk, (ci, co, n, _) in blocks.items():
        s[f"backbone_2d.blocks.{blk}.1.weight"] = t(co, ci, 3, 3)
        bn(f"backbone_2d.blocks.{blk}.2", co, s)
        for li in range(n):
            s[f"backbone_2d.blocks.{blk}.{4 + 3 * li}.weight"] = t(co, co, 3, 3)
            bn(f"backbone_2d.blocks.{blk}.{5 + 3 * li}", co, s)
    s["backbone_2d.deblocks.0.0.weight"] = t(128, 256, 1, 1)  # CT (in,out,k,k)
    bn("backbone_2d.deblocks.0.1", 256, s)
    s["backbone_2d.deblocks.1.0.weight"] = t(256, 256, 2, 2)
    bn("backbone_2d.deblocks.1.1", 256, s)
    for name, co in (("conv_cls", 2), ("conv_box", 14), ("conv_dir_cls", 4)):
        s[f"dense_head.{name}.weight"] = t(co, 512, 1, 1)
        s[f"dense_head.{name}.bias"] = t(co)
    return s


def test_second_conversion_coverage_and_dense_oracle(rng):
    import jax
    import jax.numpy as jnp
    import torch

    from modest_tpu.models import build_network
    from modest_tpu.models.sparse_conv import SubMConv3d
    from modest_tpu.train.torch_convert import convert_torch_state
    from modest_tpu.utils.config import cfg_from_yaml_file

    cfg = cfg_from_yaml_file("configs/models/lyft_models/second_dynamic_obj.yaml")
    pcr = np.array(cfg.DATA_CONFIG.POINT_CLOUD_RANGE, np.float32)
    vs = [0.05, 0.05, 0.1]

    class DS:
        point_cloud_range = pcr
        voxel_size = vs
        grid_size = np.round((pcr[3:6] - pcr[0:3]) / np.array(vs)).astype(np.int64)
        class_names = cfg.CLASS_NAMES

    model = build_network(cfg.MODEL, num_class=1, dataset=DS)
    pts = jnp.asarray(
        np.random.RandomState(0).uniform(0, 20, (1, 512, 4)).astype(np.float32))
    var = model.init(
        {"params": jax.random.PRNGKey(0), "sampler": jax.random.PRNGKey(1)},
        pts, jnp.zeros((1, 2, 8), jnp.float32), train=True)
    state = _synth_second_state(rng)
    params, stats, report = convert_torch_state(state, var["params"],
                                                var["batch_stats"])
    want = set(_leaf_paths(params)) | set(_leaf_paths(stats))
    missing = want - set(report.converted)
    assert not missing, f"unconverted leaves: {sorted(missing)[:10]}"
    assert not report.skipped_ref

    # dense oracle: spconv1-layout weight ≡ torch Conv3d on a fully-active
    # grid ≡ our SubMConv3d with the converted flattened kernel
    w_sp = state["backbone_3d.conv_input.0.weight"]          # (3,3,3,4,16)
    conv = torch.nn.Conv3d(4, 16, 3, padding=1, bias=False)
    with torch.no_grad():
        conv.weight.copy_(w_sp.permute(4, 3, 0, 1, 2))       # (out,in,kz,ky,kx)
    nz = ny = nx = 4
    dense = rng.randn(nz, ny, nx, 4).astype(np.float32)
    with torch.no_grad():
        ref_out = conv(torch.from_numpy(
            dense.transpose(3, 0, 1, 2)[None])).numpy()[0].transpose(1, 2, 3, 0)

    zz, yy, xx = np.meshgrid(range(nz), range(ny), range(nx), indexing="ij")
    coords = np.stack([zz.ravel(), yy.ravel(), xx.ravel()], 1).astype(np.int32)
    keys = (coords[:, 0] * ny * nx + coords[:, 1] * nx + coords[:, 2]).astype(np.int32)
    feats = dense.reshape(-1, 4)
    valid = np.ones(len(keys), bool)
    out = SubMConv3d(16).apply(
        {"params": {"kernel": jnp.asarray(
            params["backbone_3d"]["conv_input"]["SubMConv3d_0"]["kernel"])}},
        jnp.asarray(feats)[None], jnp.asarray(coords)[None],
        jnp.asarray(keys)[None], jnp.asarray(valid)[None], (nz, ny, nx))[0]
    np.testing.assert_allclose(np.asarray(out).reshape(nz, ny, nx, 16),
                               ref_out, atol=2e-4)


def test_pth_roundtrip(ref_modules, tmp_path):
    """torch.save → load_reference_pth populates a real TrainState."""
    import optax
    import torch

    import jax
    import jax.numpy as jnp

    from modest_tpu.models.pointrcnn import PointRCNN
    from modest_tpu.train.state import create_train_state
    from modest_tpu.train.torch_convert import load_reference_pth
    from modest_tpu.utils.config import cfg_from_yaml_file

    path = tmp_path / "checkpoint_epoch_60.pth"
    torch.save({"epoch": 60, "it": 1, "model_state": ref_modules.model_state,
                "version": "pcdet+0.3.0+ref"}, path)

    cfg = cfg_from_yaml_file("configs/models/lyft_models/pointrcnn_dynamic_obj.yaml")
    model = PointRCNN(model_cfg=cfg.MODEL, num_class=1)
    sample = {"points": np.random.RandomState(0).randn(1, 512, 4).astype(np.float32),
              "gt_boxes": np.zeros((1, 2, 8), np.float32)}
    state = create_train_state(model, optax.sgd(0.1), sample)
    new_state, report = load_reference_pth(path, state)
    assert len(report.converted) > 250
    w = ref_modules.model_state["point_head.cls_layers.6.weight"].numpy()
    np.testing.assert_allclose(
        np.asarray(new_state.params["point_head"]["FCHead_0"]["Dense_0"]["kernel"]),
        w.T, atol=1e-7)


def test_second_spconv2_layout_detection(rng):
    """A spconv-2.x checkpoint (out, kz, ky, kx, in) converts to the SAME
    kernels as its spconv-1.x twin — incl. square layers, where per-tensor
    shape probing would silently misread (layout is decided once from the
    non-square conv_input)."""
    import jax
    import jax.numpy as jnp
    import torch

    from modest_tpu.models import build_network
    from modest_tpu.train.torch_convert import convert_torch_state
    from modest_tpu.utils.config import cfg_from_yaml_file

    cfg = cfg_from_yaml_file("configs/models/lyft_models/second_dynamic_obj.yaml")
    pcr = np.array(cfg.DATA_CONFIG.POINT_CLOUD_RANGE, np.float32)
    vs = [0.05, 0.05, 0.1]

    class DS:
        point_cloud_range = pcr
        voxel_size = vs
        grid_size = np.round((pcr[3:6] - pcr[0:3]) / np.array(vs)).astype(np.int64)
        class_names = cfg.CLASS_NAMES

    model = build_network(cfg.MODEL, num_class=1, dataset=DS)
    pts = jnp.asarray(
        np.random.RandomState(0).uniform(0, 20, (1, 512, 4)).astype(np.float32))
    var = model.init(
        {"params": jax.random.PRNGKey(0), "sampler": jax.random.PRNGKey(1)},
        pts, jnp.zeros((1, 2, 8), jnp.float32), train=True)

    state1 = _synth_second_state(rng)
    state2 = {}
    for k, v in state1.items():
        if k.startswith("backbone_3d") and k.endswith(".0.weight") and v.dim() == 5:
            v = v.permute(4, 0, 1, 2, 3).contiguous()  # → (out, kz, ky, kx, in)
        state2[k] = v
    p1, _, _ = convert_torch_state(state1, var["params"], var["batch_stats"])
    p2, _, _ = convert_torch_state(state2, var["params"], var["batch_stats"])
    for name in ("conv1", "conv2_a"):  # square layers: 16→16, 32→32
        np.testing.assert_array_equal(
            np.asarray(p1["backbone_3d"][name]["SubMConv3d_0"]["kernel"]),
            np.asarray(p2["backbone_3d"][name]["SubMConv3d_0"]["kernel"]))
    np.testing.assert_array_equal(
        np.asarray(p1["backbone_3d"]["conv_out"]["kernel"]),
        np.asarray(p2["backbone_3d"]["conv_out"]["kernel"]))


# ---------------------------------------------------------------------------
# CaDDN DeepLabV3 DDN (VERDICT r4 item 9): hand-built torch oracle with
# torchvision deeplabv3_resnet* module naming (torchvision itself is not in
# the image) → convert_caddn_ddn_state → forward equality in eval mode.
# ---------------------------------------------------------------------------


def _build_torch_ddn(num_classes: int, blocks=(3, 4, 6, 3)):
    import torch
    import torch.nn as nn
    import torch.nn.functional as F

    class Bottleneck(nn.Module):
        def __init__(self, inplanes, planes, stride=1, dilation=1,
                     has_down=False):
            super().__init__()
            self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(planes)
            self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride,
                                   padding=dilation, dilation=dilation,
                                   bias=False)
            self.bn2 = nn.BatchNorm2d(planes)
            self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
            self.bn3 = nn.BatchNorm2d(planes * 4)
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
                nn.BatchNorm2d(planes * 4)) if has_down else None

        def forward(self, x):
            idt = x if self.downsample is None else self.downsample(x)
            y = F.relu(self.bn1(self.conv1(x)))
            y = F.relu(self.bn2(self.conv2(y)))
            y = self.bn3(self.conv3(y))
            return F.relu(y + idt)

    class Backbone(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
            self.bn1 = nn.BatchNorm2d(64)
            self.maxpool = nn.MaxPool2d(3, 2, 1)
            inp = 64
            strides, dil = (1, 2, 1, 1), (1, 1, 2, 4)
            for li, (n, w) in enumerate(zip(blocks, (64, 128, 256, 512))):
                layers = []
                for bi in range(n):
                    d0 = dil[li - 1] if li > 0 else 1
                    layers.append(Bottleneck(
                        inp, w, stride=strides[li] if bi == 0 else 1,
                        dilation=d0 if bi == 0 else dil[li], has_down=bi == 0))
                    inp = w * 4
                setattr(self, f"layer{li + 1}", nn.Sequential(*layers))

        def forward(self, x):
            x = F.relu(self.bn1(self.conv1(x)))
            x = self.maxpool(x)
            feats = self.layer1(x)
            out = self.layer4(self.layer3(self.layer2(feats)))
            return feats, out

    class ASPP(nn.Module):
        def __init__(self, in_ch=2048, out=256, rates=(12, 24, 36)):
            super().__init__()
            mods = [nn.Sequential(nn.Conv2d(in_ch, out, 1, bias=False),
                                  nn.BatchNorm2d(out), nn.ReLU())]
            for r in rates:
                mods.append(nn.Sequential(
                    nn.Conv2d(in_ch, out, 3, padding=r, dilation=r, bias=False),
                    nn.BatchNorm2d(out), nn.ReLU()))
            mods.append(nn.Sequential(
                nn.AdaptiveAvgPool2d(1), nn.Conv2d(in_ch, out, 1, bias=False),
                nn.BatchNorm2d(out), nn.ReLU()))
            self.convs = nn.ModuleList(mods)
            self.project = nn.Sequential(
                nn.Conv2d(5 * out, out, 1, bias=False), nn.BatchNorm2d(out),
                nn.ReLU(), nn.Dropout(0.5))

        def forward(self, x):
            res = []
            for i, conv in enumerate(self.convs):
                y = conv(x)
                if i == 4:
                    y = F.interpolate(y, size=x.shape[-2:], mode="bilinear",
                                      align_corners=False)
                res.append(y)
            return self.project(torch.cat(res, dim=1))

    class DDN(nn.Module):
        def __init__(self):
            super().__init__()
            self.backbone = Backbone()
            self.classifier = nn.Sequential(
                ASPP(), nn.Conv2d(256, 256, 3, padding=1, bias=False),
                nn.BatchNorm2d(256), nn.ReLU(), nn.Conv2d(256, num_classes, 1))

        def forward(self, x):
            feats, out = self.backbone(x)
            logits = self.classifier(out)
            logits = F.interpolate(logits, size=feats.shape[-2:],
                                   mode="bilinear", align_corners=False)
            return feats, logits

    model = DDN().eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.uniform_(-0.3, 0.3)
                m.running_var.uniform_(0.5, 1.5)
    return model


def test_caddn_ddn_deeplabv3_convert_forward_parity():
    import jax
    import jax.numpy as jnp
    import torch

    from modest_tpu.models.ddn_deeplabv3 import DDNDeepLabV3
    from modest_tpu.train.torch_convert import convert_caddn_ddn_state

    torch.manual_seed(5)
    num_classes = 17
    tm = _build_torch_ddn(num_classes, blocks=(3, 4, 6, 3))

    ours = DDNDeepLabV3(num_classes=num_classes, backbone_name="ResNet50")
    rng = np.random.RandomState(0)
    img = rng.rand(1, 64, 96, 3).astype(np.float32)
    var = ours.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(img),
                    train=False)

    params, stats, report = convert_caddn_ddn_state(
        tm.state_dict(), {"ddn": var["params"]},
        {"ddn": var["batch_stats"]})
    assert not report.skipped_ref, report.skipped_ref[:8]
    assert len(report.converted) > 250

    feats, logits = ours.apply(
        {"params": params["ddn"], "batch_stats": stats["ddn"]},
        jnp.asarray(img), train=False)
    with torch.no_grad():
        tf, tl = tm(torch.from_numpy(img.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(np.asarray(feats),
                               tf.numpy().transpose(0, 2, 3, 1),
                               rtol=1e-3, atol=2e-4)
    np.testing.assert_allclose(np.asarray(logits),
                               tl.numpy().transpose(0, 2, 3, 1),
                               rtol=1e-3, atol=2e-4)


def test_caddn_ddn_pcdet_prefixed_state_converts():
    """A full pcdet CaDDN model_state (vfe.ffn.ddn.model.* + channel_reduce)
    maps into the CaDDN DeepLab-path trees, including CHANNEL_REDUCE."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from modest_tpu.models import caddn as cd
    from modest_tpu.train.torch_convert import convert_caddn_ddn_state
    from modest_tpu.utils.config import Config

    torch.manual_seed(3)
    num_bins = 16
    tm = _build_torch_ddn(num_bins + 1, blocks=(3, 4, 6, 3))
    reduce_conv = torch.nn.Conv2d(256, 16, 1, bias=False)
    reduce_bn = torch.nn.BatchNorm2d(16)
    with torch.no_grad():
        reduce_bn.running_mean.uniform_(-0.2, 0.2)
        reduce_bn.running_var.uniform_(0.6, 1.4)
    state = {f"vfe.ffn.ddn.model.{k}": v for k, v in tm.state_dict().items()}
    state.update({f"vfe.ffn.channel_reduce.conv.{k}": v
                  for k, v in reduce_conv.state_dict().items()})
    state.update({f"vfe.ffn.channel_reduce.bn.{k}": v
                  for k, v in reduce_bn.state_dict().items()})
    state["dense_head.conv_cls.weight"] = torch.zeros(2, 2, 1, 1)  # unmapped

    from tests.test_caddn import caddn_model_cfg

    cfg = caddn_model_cfg()
    cfg.FFE.DDN = Config({"NAME": "DDNDeepLabV3", "BACKBONE_NAME": "ResNet50"})
    cfg.FFE.CHANNEL_REDUCE = Config({"in_channels": 256, "out_channels": 16,
                                     "bias": False})
    cfg.FFE.NUM_FEATURES = 16
    cfg.FFE.DISC_CFG.num_bins = num_bins
    model = cd.CaDDN(model_cfg=cfg, num_class=1,
                     point_cloud_range=[0, -8, -3, 16, 8, 1],
                     voxel_size=[0.5, 0.5, 0.5], grid_size=(32, 32, 8))
    rng = np.random.RandomState(0)
    b, h, w = 1, 32, 64
    images = jnp.asarray(rng.rand(b, h, w, 3), jnp.float32)
    l2c = jnp.asarray(np.tile(np.array(
        [[0.0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0], [0, 0, 0, 1]],
        np.float32), (b, 1, 1)))
    c2i = jnp.asarray(np.tile(np.array(
        [[40.0, 0, w / 2, 0], [0, 40.0, h / 2, 0], [0, 0, 1, 0]],
        np.float32), (b, 1, 1)))
    gt = np.zeros((b, 2, 8), np.float32)
    gt[:, 0, :7] = [5, 0, -1, 4, 2, 1.5, 0.2]
    gt[:, 0, 7] = 1
    variables = model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        images, l2c, c2i, jnp.asarray(gt), train=True)

    params, stats, report = convert_caddn_ddn_state(
        state, variables["params"], variables["batch_stats"])
    assert len(report.converted) > 250
    # channel_reduce conv + bn landed
    np.testing.assert_allclose(
        np.asarray(params["channel_reduce"]["kernel"]).reshape(256, 16),
        reduce_conv.weight.detach().numpy().reshape(16, 256).T, atol=1e-6)
    np.testing.assert_allclose(np.asarray(stats["channel_reduce_bn"]["mean"]),
                               reduce_bn.running_mean.numpy(), atol=1e-6)
    # non-DDN tensors are reported unmapped, not silently eaten
    assert "dense_head.conv_cls.weight" in report.skipped_ref
    # converted model still runs eval
    out = model.apply({"params": params, "batch_stats": stats},
                      images, l2c, c2i, train=False)
    assert np.isfinite(np.asarray(out["batch_box_preds"])).all()
