"""Data-parallel helpers — port of ``modest_tpu/parallel/mesh.py``.

The JAX package trains data-parallel as one SPMD program: a jitted step over
*global* arrays sharded on the ``data`` axis, so everything that spans the
batch (batch-norm statistics, loss normalizers, the step's random draws) is
computed over the global batch. Here each process holds one device and its
rows of the global batch, and the same step is kept by explicit collectives:

* ``global_sum`` — a sum over the processes that autograd differentiates (its
  backward sums the gradient over the processes), for every count, sum and
  statistic that spans the batch; each process's loss is then its share of
  the global loss, and the shares' gradients summed over the processes
  (``reduce_gradients``) are the global loss's gradient;
* ``global_batch`` and ``rank_rows`` — the global batch size, and a process's
  rows of something drawn for the global batch;
* ``reduce_gradients`` — one summing all-reduce of every gradient after
  ``backward``; ``broadcast_parameters`` — rank 0's weights on every process.

Without a process group every helper is the identity and costs nothing, so a
single process computes bit for bit what it computed before. With a group
(``parallel/multihost.py``) the collectives run even at world size 1, where
each is the identity on its values.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

# collectives issued since the last reset, by helper: the forward sums, the
# backward sums (global_sum's gradient) and the gradient all-reduces
calls = {"global_sum": 0, "global_sum_backward": 0, "reduce_gradients": 0}


def world() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def distributed() -> bool:
    """Whether a process group is up (the collectives run)."""
    return dist.is_initialized()


class _GlobalSum(torch.autograd.Function):
    """The sum of ``x`` over the processes; its gradient is the sum of the
    processes' gradients of the result (each process's share of the loss
    reads the same sum)."""

    @staticmethod
    def forward(ctx, x):
        y = x.detach().clone(memory_format=torch.contiguous_format)
        calls["global_sum"] += 1
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        calls["global_sum_backward"] += 1
        dist.all_reduce(g)
        return g


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the processes (differentiable); ``x`` itself
    without a process group."""
    if not dist.is_initialized():
        return x
    return _GlobalSum.apply(x)


def global_batch(b: int) -> int:
    """The global batch size of a step whose processes each hold ``b`` rows."""
    return b * world()[1]


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over every element of the global batch, ``x`` holding this
    process's rows (the same count on every process): this process's share,
    its sum over the global element count. ``x.mean()`` in one process."""
    size = world()[1]
    if size == 1:
        return x.mean()
    return x.sum() / (x.numel() * size)


def rank_rows(x: torch.Tensor, b: int) -> torch.Tensor:
    """This process's ``b`` rows of ``x``, drawn for the global batch (rank r
    holds rows r·b … r·b + b − 1, as the loader's shards stack into the
    global batch)."""
    rank, size = world()
    if size == 1:
        return x
    return x[rank * b:(rank + 1) * b]


@torch.no_grad()
def reduce_gradients(params) -> None:
    """Sum every parameter's gradient over the processes in one coalesced
    all-reduce (a parameter without a gradient counts as zero, as the
    optimizer counts it). A no-op without a process group."""
    if not dist.is_initialized():
        return
    params = list(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    calls["reduce_gradients"] += 1
    dist.all_reduce(flat)
    offset = 0
    for p, g in zip(params, grads):  # back into the gradients' own tensors
        n = p.numel()
        p.grad = g.copy_(flat[offset:offset + n].view_as(g))
        offset += n


@torch.no_grad()
def broadcast_parameters(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers on every process (one coalesced
    broadcast per dtype). A no-op without a process group."""
    if not dist.is_initialized():
        return
    tensors = list(module.state_dict().values())
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        group = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, src=0)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def broadcast_object(value):
    """Rank 0's ``value`` (picklable) on every process; ``value`` without a
    process group."""
    if not dist.is_initialized():
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier() -> None:
    """Wait for every process; a no-op without a process group."""
    if dist.is_initialized():
        dist.barrier()
