"""The plain reference agrees with the port's CPU path at small sizes, the
weights reach both sides whole, and the FLOP counter counts what it says."""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch
from torch import nn

from bench_h100.harness import compare, flops
from bench_h100.harness.manifest import load_module
from bench_h100.traffic.lyft_scans import make_pool

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = ("pointrcnn_dynamic_obj", "second_dynamic_obj")


def build_pair(name: str, seed: int, points, gt_boxes):
    cfg = json.loads((ROOT / "bench_h100" / "configs" / f"{name}.json").read_text())
    recipe = load_module(ROOT / "bench_h100" / "configs" / f"{name}.py", f"cfg_{name}")
    reference = recipe.build_reference(cfg, "cpu")
    recipe.prepare_weights(reference, cfg, seed, points, gt_boxes)
    port = recipe.build_port(cfg, "cpu")
    port.load_state_dict(reference.state_dict())
    return cfg, recipe, reference, port


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_agrees_with_the_port_on_the_cpu(name):
    from modest_tpu_torch.models import api

    torch.manual_seed(0)
    cfg = json.loads((ROOT / "bench_h100" / "configs" / f"{name}.json").read_text())
    n = 4096 if name.startswith("pointrcnn") else 65536
    points, gt = make_pool(2 ** 31 + 3, 1, 1, n, cfg["DATA_CONFIG"]["POINT_CLOUD_RANGE"])
    pool, gt = torch.from_numpy(points), torch.from_numpy(gt[0])
    points = pool[0]
    cfg, recipe, reference, port = build_pair(name, 11, pool, gt)
    out = api.apply_eval(port, port.model_cfg, points)
    final = api.post_process(out, port.model_cfg)
    want_out, want_final = recipe.reference_eval(reference, cfg, points)
    tally = compare.Tally()
    recipe.compare_batch(tally, out, final, want_out, want_final)
    assert all(v == 0.0 for v in tally.numbers().values()), tally.numbers()
    assert int(final["valid"].sum()) > 0


def test_seeded_weights_are_the_seeds_and_reach_every_weight():
    from bench_h100.traffic.weights import seeded_weights

    def make():
        return nn.Sequential(nn.Linear(8, 16), nn.BatchNorm1d(16), nn.Conv2d(3, 4, 3))

    a, b, c = make(), make(), make()
    seeded_weights(a, 5)
    seeded_weights(b, 5)
    seeded_weights(c, 6)
    for pa, pb, pc in zip(a.state_dict().values(), b.state_dict().values(),
                          c.state_dict().values()):
        assert torch.equal(pa, pb)
    assert not torch.equal(a[0].weight, c[0].weight)
    assert float(a[0].weight.detach().abs().max()) <= 8 ** -0.5
    assert float(a[0].bias.detach().abs().max()) == 0
    assert float(a[1].running_var.min()) >= 0.5


def test_flop_counter_counts_dense_and_sparse_multiply_adds():
    from bench_h100.reference import sparse_conv

    model = nn.Sequential(nn.Linear(8, 16), nn.Conv2d(16, 4, 3, padding=1),
                          nn.ConvTranspose2d(4, 2, 2, stride=2))

    def forward():
        x = model[0](torch.zeros(5, 8))
        y = model[1](torch.zeros(1, 16, 6, 6))
        model[2](y)

    assert flops.count(model, forward) == (2 * 5 * 16 * 8 + 2 * 4 * 36 * 16 * 9
                                           + 2 * 4 * 36 * 2 * 4)
    conv = sparse_conv.SubMConv3d(3, 5)
    conv.weight.data.normal_()
    feats = torch.randn(1, 4, 3)
    rows = torch.tensor([[[0, 1, 4] + [4] * 24, [1, 4, 4] + [4] * 24, [4] * 27, [3] + [4] * 26]])
    valid = torch.tensor([[True, True, False, True]])
    assert flops.count(conv, lambda: conv(feats, rows, valid), sparse_conv) == 2 * 4 * 3 * 5
