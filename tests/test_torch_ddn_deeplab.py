"""CaDDN's DeepLabV3 DDN in the PyTorch port against the JAX package on the
CPU (ResNet-50 at a 64 × 96 image, as ``tests/test_caddn.py`` runs it): the
eval forward of a hand-built torchvision-named state carried into JAX by
``convert_caddn_ddn_state`` and into the port by its converter, a pcdet
CaDDN state's keys, and the CaDDN DeepLab train forward and loss with JAX's
ASPP dropout mask (one jitted JAX train forward; no JAX gradient)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modest_tpu.models import caddn as jcd
from modest_tpu.models.ddn_deeplabv3 import DDNDeepLabV3 as JDDN
from modest_tpu.train.torch_convert import convert_caddn_ddn_state
from modest_tpu.utils.config import Config as JConfig
from modest_tpu_torch.models import api, build_network
from modest_tpu_torch.models.convert import caddn_state_dict_from_jax, state_dict_from_pcdet
from modest_tpu_torch.utils.config import Config
from tests.test_torch_caddn import GS, PCR, VS, camera_batch, tiny_cfg
from tests.test_torch_convert import _build_torch_ddn
from tests.torch_detector_pair import seeded
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

NUM_BINS = 8
H, W = 64, 96


def deeplab_cfg():
    cfg = tiny_cfg()
    cfg["FFE"]["DDN"] = {"NAME": "DDNDeepLabV3", "BACKBONE_NAME": "ResNet50",
                         "FEAT_EXTRACT_LAYER": "layer1"}
    cfg["FFE"]["CHANNEL_REDUCE"] = {"in_channels": 256, "out_channels": 16, "bias": False}
    return cfg


def port_caddn(cfg):
    return build_network(Config(cfg), 1, device="cpu", dataset=type(
        "G", (), {"point_cloud_range": PCR, "voxel_size": VS, "grid_size": GS})())


@pytest.fixture(scope="module")
def torchvision_state():
    torch.manual_seed(5)
    return _build_torch_ddn(NUM_BINS + 1, blocks=(3, 4, 6, 3)).state_dict()


def test_torchvision_state_forward_equals_jax(torchvision_state):
    """The same torchvision-named state into JAX (``convert_caddn_ddn_state``)
    and into the port (``state_dict_from_pcdet``): layer1's features and the
    resized logits within 1e-4 of their scale, eval mode."""
    jddn = JDDN(num_classes=NUM_BINS + 1, backbone_name="ResNet50")
    img = np.random.RandomState(0).rand(2, H, W, 3).astype(np.float32)
    shapes = jax.eval_shape(lambda x: jddn.init(jax.random.PRNGKey(0), x), jnp.asarray(img))
    params, stats = seeded(shapes)
    params, stats, report = convert_caddn_ddn_state(torchvision_state, {"ddn": params},
                                                    {"ddn": stats})
    assert not report.skipped_ref
    feats, logits = jax.jit(lambda v, x: jddn.apply(v, x, train=False))(
        {"params": params["ddn"], "batch_stats": stats["ddn"]}, jnp.asarray(img))

    model = port_caddn(deeplab_cfg())
    sd = state_dict_from_pcdet(dict(torchvision_state), model)
    assert set(sd) == {k for k in model.state_dict() if k.startswith("ddn.")}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected and all(not k.startswith("ddn.") for k in missing)
    model.eval()
    with torch.no_grad():
        got_f, got_l = model.ddn(torch.from_numpy(img).permute(0, 3, 1, 2))
    for got, want in ((got_f, feats), (got_l, logits)):
        want = np.asarray(want).transpose(0, 3, 1, 2)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * max(np.abs(want).max(), 1.0))


def test_pcdet_state_keys(torchvision_state):
    """A pcdet CaDDN state: ``vfe.ffn.ddn.model.`` → ``ddn.``, the channel
    reduce → ``channel_reduce.``, torchvision's ``aux_classifier`` dropped,
    the classifier's last layer dropped at another class count (as JAX
    and the reference drop it), the rest as it is."""
    model = port_caddn(deeplab_cfg())
    state = {f"vfe.ffn.ddn.model.{k}": v for k, v in torchvision_state.items()}
    state["vfe.ffn.ddn.model.aux_classifier.0.weight"] = torch.zeros(1)
    state["vfe.ffn.channel_reduce.conv.weight"] = torch.ones(16, 256, 1, 1)
    state["dense_head.conv_cls.bias"] = torch.zeros(2)
    sd = state_dict_from_pcdet(state, model)
    assert torch.equal(sd["channel_reduce.conv.weight"], torch.ones(16, 256, 1, 1))
    assert "dense_head.conv_cls.bias" in sd and not any("aux" in k for k in sd)
    assert torch.equal(sd["ddn.backbone.layer3.5.conv2.weight"],
                       torchvision_state["backbone.layer3.5.conv2.weight"])
    assert "ddn.classifier.4.weight" in sd
    state["vfe.ffn.ddn.model.classifier.4.weight"] = torch.zeros(21, 256, 1, 1)
    state["vfe.ffn.ddn.model.classifier.4.bias"] = torch.zeros(21)
    sd = state_dict_from_pcdet(state, model)
    assert not any(k.startswith("ddn.classifier.4.") for k in sd)


@pytest.fixture(scope="module")
def train_pair():
    """CaDDN with the ResNet-50 DDN at a 64 × 96 image: one jitted JAX train
    forward and loss with its ASPP dropout output captured; the port at the
    same weights, handed the nonzero pattern of that output as its mask."""
    cfg = deeplab_cfg()
    jmodel = jcd.CaDDN(model_cfg=JConfig(cfg), num_class=1, point_cloud_range=PCR,
                       voxel_size=VS, grid_size=GS)
    batch = camera_batch(seed=4, h=H, w=W)
    jin = [jnp.asarray(batch[k]) for k in ("images", "trans_lidar_to_cam", "trans_cam_to_img")]
    jgt = jnp.asarray(batch["gt_boxes"])
    params, stats = seeded(jax.eval_shape(lambda *a: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, *a, train=True),
        *jin, jgt))
    jcfg = JConfig(cfg)

    def train(p, s):
        out, mut = jmodel.apply(
            {"params": p, "batch_stats": s}, *jin, jgt, train=True,
            rngs={"dropout": jax.random.PRNGKey(2)}, mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda mdl, _: type(mdl).__name__ == "Dropout")
        out["gt_boxes2d"] = jnp.asarray(batch["gt_boxes2d"])
        _, metrics = jcd.caddn_loss(out, jgt, jcfg, depth_maps=jnp.asarray(batch["depth_maps"]))
        drop = mut["intermediates"]["ddn"]["aspp"]["Dropout_0"]["__call__"][0]
        return metrics, drop

    metrics, drop = jax.jit(train)(params, stats)
    model = port_caddn(cfg)
    model.load_state_dict(caddn_state_dict_from_jax(params, stats, Config(cfg)))
    mask = torch.from_numpy(np.asarray(drop) != 0).permute(0, 3, 1, 2)
    inputs = {k: torch.from_numpy(v) for k, v in batch.items()}
    gt = inputs.pop("gt_boxes")
    out = api.apply_train(model, Config(cfg), inputs, gt, dropout=mask)
    _, got = api.compute_loss(out, gt, Config(cfg))
    return ({k: float(v) for k, v in metrics.items()},
            {k: float(v.detach()) for k, v in got.items()}, mask)


# the total loss and its parts within 1e-5 relative of JAX's; the box and
# direction terms within 2e-4: after 50 train-mode layers each package's
# float32 value of these two is 3e-6 to 1.2e-4 from a float64 run of the port
# on the same weights and mask (JAX's loc term 1.2e-4, the port's 3.3e-5)
@pytest.mark.parametrize("key,rtol", [("loss", 1e-5), ("depth_loss", 1e-5),
                                      ("rpn_loss_cls", 1e-5), ("rpn_loss_loc", 2e-4),
                                      ("rpn_loss_dir", 2e-4)])
def test_train_loss_with_jax_dropout_mask(train_pair, key, rtol):
    want, got, mask = train_pair
    # a real mask: about half of the ReLU's nonzero outputs kept
    assert 0.15 < mask.float().mean() < 0.4
    assert want[key] > 0
    assert abs(got[key] - want[key]) <= rtol * abs(want[key]), (got[key], want[key])


def test_dropout_generator_draws_a_fresh_mask():
    """Without a mask the ASPP draws one from the generator: the same seed
    gives the same output, another seed another, eval mode none."""
    from modest_tpu_torch.models.ddn_deeplabv3 import ASPP

    torch.manual_seed(0)
    aspp = ASPP(c_in=32, channels=8, rates=(1, 2, 3)).train()
    x = torch.rand(2, 32, 6, 7)
    outs = [aspp(x, torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    kept = outs[0] != 0
    assert 0.2 < kept.float().mean() < 0.6
    aspp.eval()
    assert (aspp(x) != 0).float().mean() > kept.float().mean()
