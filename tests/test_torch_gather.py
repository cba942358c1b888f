"""Label-table gathers in the PyTorch port vs the JAX probe kernels.

``scripts_dev/gather_probe.py`` runs its whole probe when imported, so its
two Pallas kernels, ``_probe_kernel`` (``pallas_take``) and
``_probe_kernel2`` (``pallas_taa``), are read out of the file with ``ast``
and run in interpret mode with the script's VMEM specs. The port's plain
twins (what a CPU tensor runs, and what the CUDA kernels in
modest_tpu_torch/csrc/gather.cu are held to on the card) must equal them
exactly.
"""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from modest_tpu_torch.ops import gather as tg
from modest_tpu_torch.tools import gather_probe as tprobe
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

PROBE = Path(__file__).resolve().parents[1] / "scripts_dev" / "gather_probe.py"


def _probe_kernels():
    """The script's two kernel functions, compiled from its source alone."""
    tree = ast.parse(PROBE.read_text())
    defs = [node for node in tree.body
            if isinstance(node, ast.FunctionDef) and node.name in ("_probe_kernel",
                                                                   "_probe_kernel2")]
    assert len(defs) == 2
    namespace = {"jnp": jnp}
    exec(compile(ast.Module(body=defs, type_ignores=[]), str(PROBE), "exec"), namespace)
    return namespace["_probe_kernel"], namespace["_probe_kernel2"]


def _pallas(kernel, tab, idx):
    """The script's pallas_call: whole arrays in VMEM, interpret mode."""
    return np.asarray(pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(idx.shape, tab.dtype),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM), pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(jnp.asarray(tab), jnp.asarray(idx)))


def _probe_data(n=4096, k=70, w=4096, seed=0):
    """The script's recipe at a small N: banded indices, a label permutation."""
    rng = np.random.RandomState(seed)
    off = rng.randint(-w // 2, w // 2, size=(n, k))
    idx = np.clip(np.arange(n)[:, None] + off, 0, n - 1).astype(np.int32)
    labels = rng.permutation(n).astype(np.int32)
    return labels, idx


def test_take_plain_equals_the_pallas_take_probe():
    """The script's first D probe: tab (1024,), idx (256, 70) % 1024."""
    take_kernel, _ = _probe_kernels()
    labels, idx = _probe_data()
    tab, small = labels[:1024], idx[:256] % 1024
    want = _pallas(take_kernel, tab, small)
    got = tg.take(torch.from_numpy(tab), torch.from_numpy(small)).numpy()
    assert got.dtype == np.int32 and got.shape == (256, 70)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tab[small])


@pytest.mark.parametrize("rows", [8, 256])
def test_take_along_axis_plain_equals_the_pallas_taa_probe(rows):
    """The script's D2 probes: tab (R, 4096) tiled labels, idx (R, 70) % 4096."""
    _, taa_kernel = _probe_kernels()
    labels, idx = _probe_data()
    tab = np.tile(labels[None, :4096], (rows, 1))
    tab[:, ::3] += np.arange(rows, dtype=np.int32)[:, None]  # rows differ
    sub = idx[:rows] % 4096
    want = _pallas(taa_kernel, tab, sub)
    got = tg.take_along_axis(torch.from_numpy(tab), torch.from_numpy(sub)).numpy()
    assert got.dtype == np.int32 and got.shape == (rows, 70)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.take_along_axis(tab, sub, 1))


def _other_indices(kind, n, rows, k=70, seed=5):
    """Indices of kinds the probe does not draw (they take the CUDA take
    kernel's read-only branch): uniform over the whole table, or each row's
    band as wide as the table itself, clipped at both ends."""
    rng = np.random.RandomState(seed)
    if kind == "uniform":
        return rng.randint(0, n, size=(rows, k)).astype(np.int32)
    off = rng.randint(-n, n, size=(rows, k))
    return np.clip(np.arange(rows)[:, None] * (n // rows) + off, 0, n - 1).astype(np.int32)


def _at_storage_offset(a, offset):
    """``a``'s values in a contiguous tensor that starts ``offset`` elements
    into its storage (at 1, its data is not 16-byte aligned)."""
    buf = torch.zeros(a.size + offset, dtype=torch.int32)
    view = buf[offset:].view(a.shape)
    view.copy_(torch.from_numpy(a))
    assert view.is_contiguous() and view.storage_offset() == offset
    return view


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("kind", ["uniform", "clipped_band"])
def test_take_plain_equals_the_pallas_take_probe_on_other_indices(kind, offset):
    take_kernel, _ = _probe_kernels()
    labels, _ = _probe_data(n=2048)
    idx = _other_indices(kind, 2048, 256)
    want = _pallas(take_kernel, labels, idx)
    got = tg.take(torch.from_numpy(labels), _at_storage_offset(idx, offset)).numpy()
    assert got.dtype == np.int32 and got.shape == (256, 70)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, labels[idx])


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("kind", ["uniform", "clipped_band"])
def test_take_along_axis_plain_equals_the_pallas_taa_probe_on_other_indices(kind, offset):
    _, taa_kernel = _probe_kernels()
    labels, _ = _probe_data()
    tab = np.tile(labels[None, :512], (8, 1))
    tab[:, ::3] += np.arange(8, dtype=np.int32)[:, None]  # rows differ
    idx = _other_indices(kind, 512, 8)
    want = _pallas(taa_kernel, tab, idx)
    got = tg.take_along_axis(torch.from_numpy(tab), _at_storage_offset(idx, offset)).numpy()
    assert got.dtype == np.int32 and got.shape == (8, 70)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.take_along_axis(tab, idx, 1))


@pytest.mark.parametrize("bad", [-1, 1024])
def test_out_of_range_indices_raise(bad):
    tab = torch.arange(1024, dtype=torch.int32)
    idx = torch.zeros((4, 70), dtype=torch.int32)
    idx[2, 5] = bad
    with pytest.raises(IndexError, match="outside its table"):
        tg.take(tab, idx)
    rows = torch.arange(4 * 1024, dtype=torch.int32).reshape(4, 1024)
    with pytest.raises(IndexError, match="outside its table"):
        tg.take_along_axis(rows, idx)


def test_dispatch_on_cpu_is_plain_and_cuda_wrappers_refuse_cpu():
    labels, idx = _probe_data(n=1024)
    tab, i = torch.from_numpy(labels), torch.from_numpy(idx)
    before = (tg.take_cuda.launches, tg.take_along_axis_cuda.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tg.take_cuda(tab, i)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tg.take_along_axis_cuda(tab[None].expand(4, -1).contiguous(), i[:4])
    with pytest.raises(ValueError, match="int32"):
        tg.take_plain(tab.long(), i)
    with pytest.raises(ValueError, match=r"tab \(R, W\)"):
        tg.take_along_axis_plain(tab, i)
    assert (tg.take_cuda.launches, tg.take_along_axis_cuda.launches) == before


def test_the_probe_tool_runs_on_the_cpu_at_a_small_size():
    """tools/gather_probe.py's probes on the CPU: every check passes, no
    time is reported (times come from the card only)."""
    rows = tprobe.run(torch.device("cpu"), n=2048, k=70, w=512, chunk=256)
    names = [r["probe"] for r in rows]
    assert names == ["A", "B", "A'", "compress", "C", "D_small", "D", "D2_8", "D2_256"]
    assert all(r.get("correct", True) for r in rows)
    assert all(r["ms"] is None for r in rows)
