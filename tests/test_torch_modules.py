"""Network modules of the PyTorch port vs the JAX package on the same weights.

Each JAX module is initialised by flax, its batch-norm parameters and
running statistics are randomised (so eval-mode BN is not the identity), and
the weights are carried into the port with modest_tpu_torch.models.convert.
Tolerance rtol = atol = 1e-4: both sides compute in f32, and only the BLAS
summation order differs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modest_tpu.models.layers import SharedMLP as JSharedMLP
from modest_tpu.models.point_head import PointHeadBox as JPointHeadBox
from modest_tpu.models.pointnet2_backbone import FPModule as JFPModule
from modest_tpu.models.pointnet2_backbone import SAModuleMSG as JSAModuleMSG
from modest_tpu.models.roi_head import PointRCNNHead as JPointRCNNHead
from modest_tpu.ops import pointnet2 as jp2
from modest_tpu_torch.models import convert
from modest_tpu_torch.models.layers import SharedMLP
from modest_tpu_torch.models.point_head import PointHeadBox
from modest_tpu_torch.models.pointnet2_backbone import FPModule, SAModuleMSG
from modest_tpu_torch.models.roi_head import PointRCNNHead
from modest_tpu_torch.utils.config import Config
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def exact_ops():
    """Exact mode is process-global (and clears jit caches): restore it."""
    prev = jp2.exact_ops()
    jp2.set_exact_ops(True)
    yield
    jp2.set_exact_ops(prev)


def _randomise_bn(variables, seed):
    """Random BN scale/bias and running mean/var (the recipe of
    tests/test_reference_parity_model.py), as plain numpy trees."""
    rng = np.random.RandomState(seed)
    ranges = {"scale": (0.5, 1.5), "bias": (-0.2, 0.2), "mean": (-0.3, 0.3), "var": (0.5, 1.5)}

    def walk(tree, in_bn=False):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = walk(v, in_bn or k.startswith("BatchNorm"))
            elif in_bn and k in ranges:
                out[k] = rng.uniform(*ranges[k], np.shape(v)).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    return walk(variables["params"]), walk(variables.get("batch_stats", {}))


def _init(module, seed, *args):
    variables = module.init(jax.random.PRNGKey(seed), *args, train=False)
    params, stats = _randomise_bn(variables, seed)
    return params, stats, {"params": params, "batch_stats": stats}


def _load(port, entries):
    port.load_state_dict(entries, strict=True)
    return port.eval()


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("use_bn", [True, False])
def test_shared_mlp(use_bn):
    x = np.random.RandomState(0).randn(2, 16, 8, 7).astype(np.float32)
    params, stats, var = _init(JSharedMLP((12, 24), use_bn=use_bn), 0, jnp.asarray(x))
    want = JSharedMLP((12, 24), use_bn=use_bn).apply(var, jnp.asarray(x), train=False)
    port = _load(SharedMLP(7, (12, 24), use_bn=use_bn), convert.mlp_state_from_jax(params, stats))
    with torch.no_grad():
        np.testing.assert_allclose(port(_t(x)).numpy(), np.asarray(want), **TOL)


def test_sa_module_msg():
    rng = np.random.RandomState(1)
    xyz = rng.uniform(-2, 2, (2, 256, 3)).astype(np.float32)
    feats = rng.randn(2, 256, 2).astype(np.float32)
    kw = dict(npoint=64, radii=(0.5, 1.0), nsamples=(8, 16), mlps=((8, 8), (8, 16)))
    j = JSAModuleMSG(**kw)
    params, stats, var = _init(j, 1, jnp.asarray(xyz), jnp.asarray(feats))
    want_xyz, want_f = j.apply(var, jnp.asarray(xyz), jnp.asarray(feats), train=False)
    entries = {}
    for s in range(2):
        entries.update({f"mlps.{s}.{k}": v for k, v in convert.mlp_state_from_jax(
            params[f"SharedMLP_{s}"], stats[f"SharedMLP_{s}"]).items()})
    port = _load(SAModuleMSG(2, **kw), entries)
    with torch.no_grad():
        got_xyz, got_f = port(_t(xyz), _t(feats))
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), **TOL)


def test_fp_module():
    rng = np.random.RandomState(2)
    unknown = rng.uniform(-2, 2, (2, 200, 3)).astype(np.float32)
    known = unknown[:, ::4].copy()
    uf = rng.randn(2, 200, 3).astype(np.float32)
    kf = rng.randn(2, 50, 5).astype(np.float32)
    args = [jnp.asarray(a) for a in (unknown, known, uf, kf)]
    params, stats, var = _init(JFPModule(mlp=(16, 8)), 2, *args)
    want = JFPModule(mlp=(16, 8)).apply(var, *args, train=False)
    port = _load(FPModule(8, (16, 8)), {f"mlp.{k}": v for k, v in convert.mlp_state_from_jax(
        params["SharedMLP_0"], stats["SharedMLP_0"]).items()})
    with torch.no_grad():
        got = port(_t(unknown), _t(known), _t(uf), _t(kf))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_point_head_box():
    x = np.random.RandomState(3).randn(2, 100, 16).astype(np.float32)
    j = JPointHeadBox(num_class=3, cls_fc=(32, 32), reg_fc=(32,), code_size=8)
    params, stats, var = _init(j, 3, jnp.asarray(x))
    want_c, want_b = j.apply(var, jnp.asarray(x), train=False)
    port = _load(PointHeadBox(16, 3, (32, 32), (32,), 8),
                 convert.point_head_state_from_jax(params, stats))
    with torch.no_grad():
        got_c, got_b = port(_t(x))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), **TOL)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), **TOL)


def test_pointrcnn_head():
    """RoI head with USE_BN False: xyz-up / merge-down without BN, the SA
    tower (FPS + ball query + GroupAll) and the FC heads with BN."""
    rng = np.random.RandomState(4)
    pooled = rng.randn(6, 64, 5 + 16).astype(np.float32)
    pooled[..., :3] = rng.uniform(-1.5, 1.5, (6, 64, 3))
    cfg = Config({"XYZ_UP_LAYER": [16, 16], "CLS_FC": [32], "REG_FC": [32], "USE_BN": False,
                  "SA_CONFIG": {"NPOINTS": [16, -1], "RADIUS": [0.8, 100], "NSAMPLE": [8, 8],
                                "MLPS": [[16, 16], [16, 32]]}})
    j = JPointRCNNHead(num_class=1, xyz_up_layer=(16, 16), cls_fc=(32,), reg_fc=(32,),
                       sa_npoints=(16, -1), sa_radii=(0.8, 100), sa_nsamples=(8, 8),
                       sa_mlps=((16, 16), (16, 32)), code_size=7, use_bn=False)
    params, stats, var = _init(j, 4, jnp.asarray(pooled))
    want_c, want_r = j.apply(var, jnp.asarray(pooled), train=False)
    port = _load(PointRCNNHead(16, cfg, num_class=1, code_size=7),
                 convert.roi_head_state_from_jax(params, stats))
    with torch.no_grad():
        got_c, got_r = port(_t(pooled))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), **TOL)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), **TOL)
