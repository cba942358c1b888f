"""The ported slice end to end: PointRCNN eval forward + post_process in the
PyTorch port vs the JAX package (exact mode), on the same weights and scenes.

Weights are drawn in the JAX model's param tree (batch-norm parameters and
running statistics away from the identity) and carried across with
state_dict_from_jax; the round trip back through
modest_tpu.train.torch_convert is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modest_tpu.models.pointrcnn import PointRCNN as JPointRCNN
from modest_tpu.models.pointrcnn import post_process as j_post_process
from modest_tpu.ops import pointnet2 as jp2
from modest_tpu.train.torch_convert import convert_pointrcnn_state
from modest_tpu.utils.config import Config as JConfig
from modest_tpu_torch.configs import POINTRCNN_DYNAMIC_OBJ
from modest_tpu_torch.models import api, build_network
from modest_tpu_torch.models.convert import state_dict_from_jax
from modest_tpu_torch.utils.config import Config
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _tiny_model_cfg():
    """The small PointRCNN of __graft_entry__._tiny_model_cfg (2 SA levels,
    widths <= 32), eval sections only; NMS_PRE_MAXSIZE (128) is below the
    scene size, so the proposal top-k branch runs."""
    return {
        "NAME": "PointRCNN",
        "BACKBONE_3D": {
            "NAME": "PointNet2MSG",
            "SA_CONFIG": {"NPOINTS": [64, 16], "RADIUS": [[0.5, 1.0], [1.0, 2.0]],
                          "NSAMPLE": [[8, 8], [8, 8]],
                          "MLPS": [[[8, 8], [8, 8]], [[16, 16], [16, 16]]]},
            "FP_MLPS": [[16, 16], [16, 16]],
        },
        "POINT_HEAD": {
            "NAME": "PointHeadBox", "CLS_FC": [16], "REG_FC": [16], "CLASS_AGNOSTIC": False,
            "TARGET_CONFIG": {"GT_EXTRA_WIDTH": [0.2, 0.2, 0.2],
                              "BOX_CODER": "PointResidualCoder",
                              "BOX_CODER_CONFIG": {"use_mean_size": True,
                                                   "mean_size": [[3.9, 1.6, 1.56]]}},
        },
        "ROI_HEAD": {
            "NAME": "PointRCNNHead", "CLASS_AGNOSTIC": True,
            "ROI_POINT_POOL": {"POOL_EXTRA_WIDTH": [0.0, 0.0, 0.0], "NUM_SAMPLED_POINTS": 32,
                               "DEPTH_NORMALIZER": 70.0},
            "XYZ_UP_LAYER": [16, 16], "CLS_FC": [16], "REG_FC": [16], "DP_RATIO": 0.0,
            "USE_BN": False,
            "SA_CONFIG": {"NPOINTS": [16, -1], "RADIUS": [0.5, 100], "NSAMPLE": [8, 8],
                          "MLPS": [[16, 16], [16, 32]]},
            "NMS_CONFIG": {
                "TRAIN": {"NMS_TYPE": "nms_gpu", "MULTI_CLASSES_NMS": False,
                          "NMS_PRE_MAXSIZE": 128, "NMS_POST_MAXSIZE": 32, "NMS_THRESH": 0.8},
                "TEST": {"NMS_TYPE": "nms_gpu", "MULTI_CLASSES_NMS": False,
                         "NMS_PRE_MAXSIZE": 128, "NMS_POST_MAXSIZE": 16, "NMS_THRESH": 0.85},
            },
            "TARGET_CONFIG": {"BOX_CODER": "ResidualCoder", "ROI_PER_IMAGE": 16,
                              "FG_RATIO": 0.5, "SAMPLE_ROI_BY_EACH_CLASS": True,
                              "CLS_SCORE_TYPE": "cls", "CLS_FG_THRESH": 0.6,
                              "CLS_BG_THRESH": 0.45, "CLS_BG_THRESH_LO": 0.1,
                              "HARD_BG_RATIO": 0.8, "REG_FG_THRESH": 0.55},
        },
        "POST_PROCESSING": {
            "SCORE_THRESH": 0.1, "OUTPUT_RAW_SCORE": False,
            "NMS_CONFIG": {"MULTI_CLASSES_NMS": False, "NMS_TYPE": "nms_gpu",
                           "NMS_THRESH": 0.1, "NMS_PRE_MAXSIZE": 4096, "NMS_POST_MAXSIZE": 500},
        },
    }


def _scenes(seed, b, n):
    """The bench.py scene recipe (x in [0, 80], y in ±40, car-sized point
    clusters), with cluster sizes scaled to the scene."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(0, 1, (b, n, 4)).astype(np.float32)
    pts[..., 0] *= 80
    pts[..., 1] = (pts[..., 1] - 0.5) * 80
    pts[..., 2] = (pts[..., 2] - 0.5) * 3 - 0.5
    per = n // 12
    for i in range(b):
        for k in range(8):
            c = rng.uniform([5, -30, -1.6], [70, 30, -1.4])
            pts[i, k * per:(k + 1) * per, :3] = c + rng.uniform(-1, 1, (per, 3)) * [2, 0.9, 0.7]
    return pts


def _jax_model(model_cfg, seed=0):
    """The JAX PointRCNN and a weight draw in its own param tree: the tree's
    shapes come from tracing flax's init (no compile); Dense kernels draw
    U(±1/sqrt(fan_in)), biases and batch-norm parameters and statistics
    draw around their init values, all from one numpy seed."""
    model = JPointRCNN(model_cfg=JConfig(model_cfg), num_class=1)
    shapes = jax.eval_shape(lambda: model.init({"params": jax.random.PRNGKey(0)},
                                               jnp.zeros((1, 1024, 4), jnp.float32), train=False))
    rng = np.random.RandomState(seed)
    ranges = {"scale": (0.5, 1.5), "bias": (-0.2, 0.2), "mean": (-0.3, 0.3), "var": (0.5, 1.5)}

    def draw(tree):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = draw(v)
            elif k == "kernel":
                bound = v.shape[0] ** -0.5
                out[k] = rng.uniform(-bound, bound, v.shape).astype(np.float32)
            else:
                out[k] = rng.uniform(*ranges[k], v.shape).astype(np.float32)
        return out

    return model, draw(shapes["params"]), draw(shapes["batch_stats"])


@pytest.fixture(scope="module")
def jax_tiny():
    return _jax_model(_tiny_model_cfg())


def _match_1to1(boxes, scores, rb, rs):
    """Greedy 1:1 match (tests/test_reference_parity_model.py): center
    < 1 cm, sizes < 2e-3, score < 5e-4."""
    used = np.zeros(len(boxes), bool)
    pairs = []
    for j in range(len(rb)):
        d = np.linalg.norm(boxes[:, :3] - rb[j, :3], axis=1)
        ds = np.abs(boxes[:, 3:6] - rb[j, 3:6]).max(axis=1)
        cand = np.flatnonzero((d < 1e-2) & (ds < 2e-3) & (np.abs(scores - rs[j]) < 5e-4) & ~used)
        if len(cand):
            used[cand[0]] = True
            pairs.append((int(cand[0]), j))
    return pairs


def _compare(model_cfg, jax_model, scenes, min_frac, max_count_diff, min_total):
    """Run both forwards + post_process on the same weights; hold the port's
    final boxes to JAX's 1:1."""
    jmodel, params, stats = jax_model
    cfg = Config(model_cfg)
    port = build_network(cfg, 1, device="cpu")
    port.load_state_dict(state_dict_from_jax(params, stats), strict=True)

    jcfg = JConfig(model_cfg)
    infer = jax.jit(lambda v, p: j_post_process(jmodel.apply(v, p, train=False),
                                                 jcfg.POST_PROCESSING))
    want = infer({"params": params, "batch_stats": stats}, jnp.asarray(scenes))
    got = api.post_process(api.apply_eval(port, cfg, torch.from_numpy(scenes)), cfg)

    total = matched = 0
    for i in range(len(scenes)):
        wv = np.asarray(want["valid"][i])
        wb, ws, wl = (np.asarray(want[k][i])[wv] for k in ("boxes", "scores", "labels"))
        gv = got["valid"][i].numpy()
        gb, gs, gl = (got[k][i].numpy()[gv] for k in ("boxes", "scores", "labels"))
        assert abs(len(gb) - len(wb)) <= max_count_diff, (i, len(gb), len(wb))
        pairs = _match_1to1(gb, gs, wb, ws)
        for a, j in pairs:
            dyaw = abs(float(gb[a, 6]) - float(wb[j, 6])) % (2 * np.pi)
            assert min(dyaw, 2 * np.pi - dyaw) < 2e-3
            assert gl[a] == wl[j]
        matched += len(pairs)
        total += max(len(wb), len(gb))
    assert total >= min_total, f"only {total} detections: the comparison is vacuous"
    assert matched / total >= min_frac, f"only {matched}/{total} detections match JAX's"


@pytest.fixture(scope="module", autouse=True)
def exact_ops():
    """Exact mode is process-global (and clears jit caches): restore it."""
    prev = jp2.exact_ops()
    jp2.set_exact_ops(True)
    yield
    jp2.set_exact_ops(prev)


def test_tiny_slice_matches_jax(jax_tiny):
    """4 scenes of 768 points: >= 99% of final boxes match JAX 1:1."""
    _compare(_tiny_model_cfg(), jax_tiny, _scenes(0, 4, 768), min_frac=0.99, max_count_diff=1,
             min_total=24)


def test_weight_round_trip_is_exact(jax_tiny):
    """JAX → state_dict_from_jax → port.state_dict() → torch_convert → JAX
    reproduces every parameter and statistic exactly."""
    _, params, stats = jax_tiny
    port = build_network(Config(_tiny_model_cfg()), 1, device="cpu")
    port.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    back_p, back_s, report = convert_pointrcnn_state(port.state_dict(), params, stats)
    assert report.skipped_ref == []

    def leaves(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, path + (k,))
            else:
                yield path + (k,), v

    want = dict(leaves({"p": params, "s": stats}))
    got = dict(leaves({"p": back_p, "s": back_s}))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg="/".join(k))


@pytest.mark.slow
def test_flagship_slice_matches_jax():
    """The flagship config at 6144 points per scene, 2 scenes."""
    _compare(POINTRCNN_DYNAMIC_OBJ, _jax_model(POINTRCNN_DYNAMIC_OBJ), _scenes(1, 2, 6144),
             min_frac=0.99, max_count_diff=1, min_total=40)
