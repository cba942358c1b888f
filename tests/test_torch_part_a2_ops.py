"""The pieces of Part-A2 in modest_tpu_torch against the JAX package:
RoI-aware pooling (max and mean), the intra-part targets, flax's SAME
padding of the RoI conv tower, the sparse inverse conv and the whole sparse
UNet with seeded weights. The detector whole is in
tests/test_torch_part_a2.py."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modest_tpu.models import part_a2 as jpa
from modest_tpu.models import sparse_conv as jsc
from modest_tpu.ops.roiaware_pool3d import roiaware_pool3d as jroiaware
from modest_tpu_torch.models import part_a2 as pa
from modest_tpu_torch.models import sparse_conv as sc
from modest_tpu_torch.models.convert import unet_state_from_jax
from modest_tpu_torch.models.voxelize import point_voxel_coords, voxelize_sparse
from modest_tpu_torch.ops.roiaware_pool3d import roiaware_pool3d
from tests.test_torch_grid_detectors import PCR, toy_batch
from tests.torch_detector_pair import GS, GT_XY, MAX_VOXELS, VS, seeded
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = {"rtol": 1e-4, "atol": 1e-4}


def _rois(rng, b, r):
    return np.concatenate([rng.uniform([-3, -3, -1], [3, 3, 1], (b, r, 3)),
                           rng.uniform(1, 4, (b, r, 3)),
                           rng.uniform(-np.pi, np.pi, (b, r, 1))], -1).astype(np.float32)


@pytest.mark.parametrize("method", ["max", "avg"])
def test_roiaware_pool3d_matches_jax(method):
    """Each scan's RoIs over its masked points (parked at 1e6, as Part-A2
    parks its padded voxels): pooled cells within 1e-5, empty cells 0."""
    rng = np.random.RandomState(0)
    pts = rng.uniform(-4, 4, (2, 600, 3)).astype(np.float32)
    pts[:, 500:] = 1e6
    feats = rng.randn(2, 600, 5).astype(np.float32)
    rois = _rois(rng, 2, 7)
    got = roiaware_pool3d(torch.from_numpy(rois), torch.from_numpy(pts), torch.from_numpy(feats),
                          (4, 3, 5), method)
    want = np.stack([np.asarray(jroiaware(jnp.asarray(rois[i]), jnp.asarray(pts[i]),
                                          jnp.asarray(feats[i]), (4, 3, 5), method))
                     for i in range(2)])
    assert got.shape == (2, 7, 4, 3, 5, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert (want == 0).all(-1).any() and (want != 0).any(-1).any()


def test_intra_part_targets_match_jax():
    rng = np.random.RandomState(1)
    centers = rng.uniform(-4, 4, (2, 400, 3)).astype(np.float32)
    valid = rng.uniform(size=(2, 400)) < 0.9
    gt = np.zeros((2, 5, 8), np.float32)
    gt[:, :3, :7] = _rois(rng, 2, 3)
    gt[:, :3, 7] = 1
    gt[1, 0, :7] = gt[1, 1, :7]  # two boxes over the same voxels: the first one counts
    seg, part = pa.intra_part_targets(torch.from_numpy(centers), torch.from_numpy(valid),
                                      torch.from_numpy(gt))
    jseg, jpart = jax.vmap(jpa.intra_part_targets)(jnp.asarray(centers), jnp.asarray(valid),
                                                   jnp.asarray(gt))
    np.testing.assert_array_equal(seg.numpy(), np.asarray(jseg))
    np.testing.assert_allclose(part.numpy(), np.asarray(jpart), rtol=1e-5, atol=1e-5)
    assert seg.sum() > 10


@pytest.mark.parametrize("size,stride", [(12, 1), (12, 2), (6, 2), (4, 2), (5, 2), (3, 1)])
def test_same_padding_is_flax_s(size, stride):
    """Conv at the port's padding gives flax's ``padding="SAME"`` output."""
    import flax.linen as fnn

    rng = np.random.RandomState(size * stride)
    x = rng.randn(2, size, size, size, 3).astype(np.float32)
    conv = fnn.Conv(4, (3, 3, 3), strides=(stride,) * 3, padding="SAME")
    variables = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(conv.apply(variables, jnp.asarray(x)))
    block = pa.ConvBlock3d(3, 4, stride)
    kernel = np.asarray(variables["params"]["kernel"])
    with torch.no_grad():
        block.conv.weight.copy_(torch.from_numpy(kernel.transpose(4, 3, 0, 1, 2).copy()))
        block.conv.bias.copy_(torch.from_numpy(np.array(variables["params"]["bias"])))
        xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
        pads = [p for n in reversed(xt.shape[2:]) for p in pa.same_padding(n, stride)]
        got = block.conv(torch.nn.functional.pad(xt, pads)).permute(0, 2, 3, 4, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _active_set(rng, shape_zyx, density, v):
    nz, ny, nx = shape_zyx
    act = rng.rand(nz * ny * nx) < density
    keys = np.full(v, nz * ny * nx, np.int64)
    on = np.nonzero(act)[0][:v]
    keys[:len(on)] = on
    coords = np.stack([keys // (ny * nx), (keys // nx) % ny, keys % nx], 1)
    return coords, keys, keys < nz * ny * nx


@pytest.mark.parametrize("padding", [(1, 1, 1), (0, 1, 1)])
def test_sparse_inverse_conv_matches_jax(padding):
    """The rulebook and one product against JAX's per-candidate weights,
    within 1e-4 relative, padded rows 0."""
    rng = np.random.RandomState(2)
    cs, fs = (3, 4, 4), (5, 8, 8)
    c_coords, c_keys, c_valid = _active_set(rng, cs, 0.5, 40)
    f_coords, f_keys, f_valid = _active_set(rng, fs, 0.4, 150)
    feats = rng.randn(40, 6).astype(np.float32)
    m = jsc.SparseInverseConv3d(5, (2, 2, 2), padding)
    b1 = lambda a: jnp.asarray(a)[None]  # noqa: E731
    args = (b1(feats), b1(c_keys.astype(np.int32)), b1(c_valid), cs,
            b1(f_coords.astype(np.int32)), b1(f_valid), fs)
    variables = m.init(jax.random.PRNGKey(0), *args)
    want = np.asarray(m.apply(variables, *args))
    port = sc.SparseInverseConv3d(6, 5, (2, 2, 2), padding)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.array(variables["params"]["kernel"]).reshape(
            3, 3, 3, 6, 5)))
        got = port(torch.from_numpy(feats)[None], torch.from_numpy(c_keys)[None],
                   torch.from_numpy(c_valid)[None], cs, torch.from_numpy(f_coords)[None],
                   torch.from_numpy(f_valid)[None])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    assert np.abs(want).sum() > 0 and (got[0][~torch.from_numpy(f_valid)] == 0).all()


def test_sparse_unet_matches_jax():
    """The whole UNet with seeded weights on the toy batch's voxels, in train
    mode (batch statistics; the eval mode runs in the whole model,
    tests/test_torch_part_a2.py): the BEV map and the full-resolution
    features within 1e-4, padded rows 0."""
    pts, _ = toy_batch(0, GT_XY)
    shape = (GS[2] + 1, GS[1], GS[0])
    points = torch.from_numpy(pts)
    coords, valid = point_voxel_coords(points, PCR, VS, GS)
    vc, vf, vv, vk = voxelize_sparse(points, valid, coords, MAX_VOXELS, *GS)
    args = (jnp.asarray(vf.numpy()), jnp.asarray(vc.numpy().astype(np.int32)),
            jnp.asarray(vk.numpy().astype(np.int32)), jnp.asarray(vv.numpy()))
    junet = jsc.SparseUNet()
    params, stats = seeded(jax.eval_shape(lambda *a: junet.init(jax.random.PRNGKey(0), *a,
                                                                shape), *args))
    jbev, ju1 = jax.jit(lambda v, *a: junet.apply(v, *a, shape, train=True,
                                                  mutable=["batch_stats"])[0])(
        {"params": params, "batch_stats": stats}, *args)
    unet = sc.SparseUNet()
    unet.load_state_dict({k: torch.from_numpy(np.array(v)) if not torch.is_tensor(v) else v
                          for k, v in unet_state_from_jax(params, stats).items()})
    unet.train()
    with torch.no_grad():
        bev, u1 = unet(vf, vc, vk, vv, shape)
    np.testing.assert_allclose(u1.numpy(), np.asarray(ju1), **TOL)
    # JAX's BEV map is (B, ny, nx, nz·C), the port's (B, nz·C, ny, nx)
    np.testing.assert_allclose(bev.permute(0, 2, 3, 1).numpy(), np.asarray(jbev), **TOL)
    assert (u1[~vv] == 0).all() and u1[vv].abs().sum() > 0
