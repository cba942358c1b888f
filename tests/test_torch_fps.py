"""FPS in the PyTorch port vs the JAX package.

The port's plain FPS (what a CPU tensor runs, and what the CUDA kernel in
modest_tpu_torch/csrc/fps.cu is held to on the card) must give the same
indices as both JAX paths: the XLA loop and the Pallas TPU kernel run in
interpret mode. Both Pallas layouts are covered (N % 1024 == 0 and not).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modest_tpu.ops.pallas_fps import furthest_point_sample_pallas
from modest_tpu.ops.pointnet2 import _furthest_point_sample_xla
from modest_tpu_torch.ops import pointnet2 as tp2
from modest_tpu_torch.ops.fps import furthest_point_sample_cuda, furthest_point_sample_plain
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize(
    "b,n,npoint",
    [
        (3, 256, 64),     # _fps_kernel layout
        (2, 1024, 130),   # _fps_kernel3d layout, npoint not a multiple of 4
        (2, 256, 1),      # npoint = 1
        (2, 1024, 1),
        (1, 256, 256),    # npoint = N: every point, then index 0 once all dists are 0
        (2, 300, 37),     # ragged N
        # the small-cloud kernel's register templates: P = ceil(N / 32) points
        # a lane, rounded up to 1, 2, 4, ..., 32, each side of every edge
        (2, 1, 1),
        (2, 31, 31),
        (2, 33, 20),
        (2, 257, 257),
        (2, 511, 128),
        (2, 513, 2),
        (1, 1023, 1023),
    ],
)
def test_fps_plain_matches_xla_and_pallas(b, n, npoint):
    x = np.random.RandomState(n + npoint).randn(b, n, 3).astype(np.float32) * 10
    want_xla = np.asarray(_furthest_point_sample_xla(jnp.asarray(x), npoint))
    want_pallas = np.asarray(furthest_point_sample_pallas(jnp.asarray(x), npoint, interpret=True))
    got = furthest_point_sample_plain(torch.from_numpy(x), npoint)
    assert got.dtype == torch.int32 and got.shape == (b, npoint)
    np.testing.assert_array_equal(got.numpy(), want_xla)
    np.testing.assert_array_equal(got.numpy(), want_pallas)


def _tie_cloud(kind, b, n, seed):
    """Clouds where the tie rule decides: ``dup_halves`` repeats the first
    half of a cloud as its second half (duplicates fall into different
    thread-block cluster ranks on the card), ``grid`` quantises to a 0.5 m
    grid (many equal distances), ``ragged`` is a size no cluster splits
    evenly."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, n, 3) * 10).astype(np.float32)
    if kind == "dup_halves":
        x[:, n // 2:] = x[:, :n - n // 2]
    elif kind == "grid":
        x = np.round(x * 2) / 2
    return x


@pytest.mark.parametrize(
    "kind,b,n,npoint",
    [
        ("dup_halves", 2, 1024, 600),  # more steps than distinct points
        ("dup_halves", 2, 600, 200),
        ("grid", 2, 1024, 256),
        ("ragged", 2, 1000, 100),
    ],
)
def test_fps_plain_on_tie_heavy_clouds_matches_xla_and_pallas(kind, b, n, npoint):
    x = _tie_cloud(kind, b, n, seed=n + npoint)
    want_xla = np.asarray(_furthest_point_sample_xla(jnp.asarray(x), npoint))
    want_pallas = np.asarray(furthest_point_sample_pallas(jnp.asarray(x), npoint, interpret=True))
    got = furthest_point_sample_plain(torch.from_numpy(x), npoint).numpy()
    np.testing.assert_array_equal(got, want_xla)
    np.testing.assert_array_equal(got, want_pallas)


def test_fps_ties_go_to_lowest_index():
    """Integer coordinates on a small grid: many equal distances, so the
    tie rule decides most steps."""
    x = np.random.RandomState(1).randint(0, 4, (2, 256, 3)).astype(np.float32)
    want = np.asarray(_furthest_point_sample_xla(jnp.asarray(x), 80))
    got = furthest_point_sample_plain(torch.from_numpy(x), 80)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fps_dispatch_on_cpu_is_plain():
    x = torch.from_numpy(np.random.RandomState(2).rand(2, 128, 3).astype(np.float32))
    np.testing.assert_array_equal(tp2.furthest_point_sample(x, 16).numpy(),
                                  furthest_point_sample_plain(x, 16).numpy())


def test_fps_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never falls back: a CPU tensor is an error, and
    the launch count does not move."""
    before = dict(furthest_point_sample_cuda.launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        furthest_point_sample_cuda(torch.zeros(1, 8, 3), 4)
    assert furthest_point_sample_cuda.launches == before
