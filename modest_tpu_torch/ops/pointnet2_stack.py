"""Stacked (ragged) PointNet++ ops, the masked ball query and grouping, and
the voxel query — port of ``modest_tpu/ops/pointnet2_stack.py``.

The reference's ``pointnet2_stack`` CUDA ops take ragged batches as flat
(sum N_i, C) tensors plus per-cloud counts. As in the JAX package the port
keeps them **padded + counted**: (B, N_max, C) with a (B,) ``cnt``;
``stack_to_padded`` / ``padded_to_stack`` convert at the host boundary, in
numpy. Padding is never chosen: ``farthest_point_sample_stack`` samples each
cloud from its first ``cnt`` points, the stacked ball query puts padding at
squared distance ``BIG`` (an empty ball is flagged and groups zeros), and
``three_nn_stack`` moves padded known points to ``BIG`` coordinates.

Two of these functions run hand-written kernels on a CUDA tensor and their
plain twins on a CPU tensor, with no fallback between the two:
``farthest_point_sample_stack`` (the FPS kernels of ``csrc/fps.cu``, or its
plain masked loop) and ``ball_query_masked`` (``csrc/ball_query.cu``, a warp
per centre that keeps the first in-ball sources by index, or
``ball_query_masked_plain``, a (B, M, N) distance matrix and a top-k). The
masked ball query serves ``query_and_group_masked``: PV-RCNN's voxel set
abstraction and RoI-grid pooling, over sparse-conv voxel lists that are not
front-packed. The other stacked functions and ``voxel_query`` (Voxel
R-CNN's neighbour lookup in the sparse backbone's sorted voxel keys) are
plain tensor code, as the JAX package's are XLA code outside Pallas.

In the mask-based ops a source set is padded to a static length and carries
a validity mask; masked sources sit at squared distance ``BIG``, so they
never fall inside a ball; the first ``nsample`` in-ball sources by index fill
the slots, as in ``ops/pointnet2.py::ball_query_from_dist2``; a centre with
no source in its ball groups zeros. The kernel decides membership on the
plain twin's squared distance (``pairwise_dist2``), bit for bit.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils import trace
from ._build import check_cuda, load_library
from .fps import furthest_point_sample_cuda
from .pointnet2 import ball_query_from_dist2, gather_points, pairwise_dist2, three_nn

BIG = 1e9


def stack_to_padded(flat: np.ndarray, cnt: np.ndarray, n_max: int | None = None):
    """Flat stacked (sum N_i, C) + counts → padded (B, N_max, C) with zero
    padding, and the counts as int32."""
    cnt = np.asarray(cnt, np.int32)
    n_max = int(cnt.max()) if n_max is None else n_max
    out = np.zeros((len(cnt), n_max) + flat.shape[1:], flat.dtype)
    off = 0
    for i, c in enumerate(cnt):
        out[i, :c] = flat[off:off + c]
        off += c
    return out, cnt


def padded_to_stack(padded: np.ndarray, cnt: np.ndarray):
    """Padded (B, N_max, C) + counts → flat stacked (sum N_i, C)."""
    return np.concatenate([padded[i, :c] for i, c in enumerate(cnt)], axis=0)


def mask_from_counts(cnt, n: int):
    """(B,) counts → (B, n) bool validity mask, on the counts' device."""
    cnt = torch.as_tensor(cnt)
    return torch.arange(n, device=cnt.device)[None, :] < cnt[:, None]


def farthest_point_sample_stack_plain(xyz, cnt, npoint: int):
    """The masked FPS loop of the JAX package: (B, N, 3) + (B,) counts →
    (B, npoint) int32. Index 0 starts each cloud; a padding row's running
    distance is pinned at −1, so the first-index argmax never picks it (a
    cloud whose valid points are all taken, or one with no point, gives
    index 0 from then on)."""
    b, n, _ = xyz.shape
    valid = mask_from_counts(torch.as_tensor(cnt, device=xyz.device), n)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    rows = torch.arange(b, device=xyz.device)
    pad = torch.tensor(-1.0, dtype=torch.float32, device=xyz.device)
    dists = torch.where(valid, torch.tensor(1e10, dtype=torch.float32, device=xyz.device), pad)
    idx = torch.zeros((b, npoint), dtype=torch.int32, device=xyz.device)
    last = torch.zeros(b, dtype=torch.long, device=xyz.device)
    for i in range(1, npoint):
        dx = x - x[rows, last][:, None]
        dy = y - y[rows, last][:, None]
        dz = z - z[rows, last][:, None]
        dists = torch.minimum(dists, torch.where(valid, dx * dx + dy * dy + dz * dz, pad))
        last = torch.argmax(dists, dim=1)
        idx[:, i] = last.to(torch.int32)
    return idx


def padding_at_first_point(xyz, cnt):
    """(B, N, 3) with every padding row set to its cloud's point 0 (a cloud
    with no point: all rows at the origin), float32 contiguous.

    Unmasked FPS on this cloud picks the masked FPS's indices. From its first
    step on, a padding row lies at distance 0 from the selected point 0, so
    its running distance is 0 while a valid point's is ≥ 0. While a valid
    point stands further off, the argmax is that point, as with padding at
    −1. Once every valid distance is 0, point 0 holds the maximum 0 at the
    lowest index, so both pick index 0, which is also what a cloud with
    cnt = 0 gives under either rule."""
    b, n, _ = xyz.shape
    cnt = torch.as_tensor(cnt, device=xyz.device)
    valid = mask_from_counts(cnt, n)
    first = torch.where((cnt > 0)[:, None], xyz[:, 0].float(), 0.0)
    return torch.where(valid[..., None], xyz.float(), first[:, None, :]).contiguous()


def farthest_point_sample_stack(xyz, cnt, npoint: int):
    """Masked FPS: (B, N, 3) + (B,) counts → (B, npoint) int32 indices below
    each cloud's count (the reference's stack_farthest_point_sample: each
    cloud samples from its own first cnt[b] points; a cloud with fewer than
    ``npoint`` repeats index 0 once its points are taken).

    A CUDA tensor goes to the FPS kernels of ``csrc/fps.cu``, one launch for
    the batch, with each cloud's padding set to its point 0
    (``padding_at_first_point``); a CPU tensor to the plain masked loop."""
    if xyz.is_cuda:
        return furthest_point_sample_cuda(padding_at_first_point(xyz, cnt), npoint)
    if xyz.device.type == "cpu":
        return farthest_point_sample_stack_plain(xyz, cnt, npoint)
    raise ValueError(f"farthest_point_sample_stack: unsupported device {xyz.device}")


def masked_pairwise_dist2(a, a_cnt, b, b_cnt):
    """(B, M, 3) vs (B, N, 3) squared distances, a pair with a padding row on
    either side at ``BIG``."""
    d2 = pairwise_dist2(a, b)
    am = mask_from_counts(torch.as_tensor(a_cnt, device=a.device), a.shape[1])
    bm = mask_from_counts(torch.as_tensor(b_cnt, device=b.device), b.shape[1])
    return torch.where(am[:, :, None] & bm[:, None, :], d2, BIG)


def ball_query_stack(xyz, xyz_cnt, new_xyz, new_cnt, radius: float, nsample: int):
    """Stacked ball query on the padded layout: (idx (B, M, nsample) int64,
    empty (B, M)), ``empty`` flagging centres with no point in their ball
    (the reference's empty_ball_mask; a padding centre is always empty)."""
    d2 = masked_pairwise_dist2(new_xyz, new_cnt, xyz, xyz_cnt)
    idx, valid = ball_query_from_dist2(d2, radius, nsample)
    return idx, ~valid[..., 0]


def _group(xyz, features, new_xyz, idx, empty, use_xyz: bool):
    """Gather the (B, M, nsample) sources around their centres, offsets to
    the centre first, zeros for an empty ball. Traced as the span ``group``."""
    with trace.span("group"):
        b, m, ns = idx.shape
        flat = idx.reshape(b, m * ns)
        grouped_xyz = gather_points(xyz, flat).reshape(b, m, ns, 3) - new_xyz[:, :, None, :]
        if features is not None:
            grouped_feat = gather_points(features, flat).reshape(b, m, ns, -1)
            out = torch.cat([grouped_xyz, grouped_feat], dim=-1) if use_xyz else grouped_feat
        else:
            out = grouped_xyz
        return torch.where(empty[:, :, None, None], 0.0, out), empty


def query_and_group_stack(xyz, xyz_cnt, features, new_xyz, new_cnt, radius: float,
                          nsample: int, use_xyz: bool = True):
    """Stacked QueryAndGroup: (B, M, nsample, 3 + C) (or C without
    ``use_xyz``, 3 without features), empty balls zeroed as the reference
    zeroes new_features[empty_ball_mask]; and the empty flags (B, M)."""
    idx, empty = ball_query_stack(xyz, xyz_cnt, new_xyz, new_cnt, radius, nsample)
    return _group(xyz, features, new_xyz, idx, empty, use_xyz)


def three_nn_stack(unknown, unknown_cnt, known, known_cnt):
    """Masked three-NN: padded ``known`` rows move to ``BIG`` coordinates, so
    they never win; rows past ``unknown_cnt`` get neighbours that the
    caller's own mask discards. Returns (dist, idx int64), (B, n, 3) each."""
    km = mask_from_counts(torch.as_tensor(known_cnt, device=known.device), known.shape[1])
    return three_nn(unknown, torch.where(km[..., None], known, BIG))


@torch.no_grad()
def ball_query_masked_plain(xyz, xyz_mask, new_xyz, radius: float, nsample: int):
    """The masked ball query in PyTorch, on any device: the kernel's plain
    twin. The (B, M, N) distance matrix of ``pairwise_dist2`` is masked in
    place, and one such matrix lives at a time."""
    d2 = pairwise_dist2(new_xyz, xyz)
    d2.masked_fill_(~xyz_mask[:, None, :], BIG)
    idx, valid = ball_query_from_dist2(d2, radius, nsample)
    return idx, ~valid[..., 0]


@functools.cache
def _lib():
    lib = load_library("ball_query")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.ball_query_launch.argtypes = [vp, vp, vp, i, i, i, ctypes.c_float, i, vp, vp, vp]
    lib.ball_query_launch.restype = i
    lib.ball_query_cross_launch.argtypes = [vp, vp, i, i, i, vp, vp]
    lib.ball_query_cross_launch.restype = i
    lib.ball_query_error_string.argtypes = [i]
    lib.ball_query_error_string.restype = ctypes.c_char_p
    return lib


BALL_QUERY_MAX_SAMPLE = 64  # csrc/ball_query.cu's slots a centre
BALL_QUERY_MAX_BATCH = 65535  # its grid's second dimension


def ball_query_cuda(xyz, xyz_mask, new_xyz, radius: float, nsample: int):
    """xyz (B, N, 3) float32, xyz_mask (B, N) bool, new_xyz (B, M, 3)
    float32, contiguous CUDA tensors on one device, 1 <= nsample <= 64, N >=
    1 and r² below ``BIG`` → (idx (B, M, nsample) int64, empty (B, M) bool)
    by the kernel in ``csrc/ball_query.cu``, one launch on the tensors'
    device and its current stream, equal to ``ball_query_masked_plain`` bit
    for bit. r² is ``radius * radius`` in the host's double, rounded to
    float32 once, as the plain twin's comparison of a float32 tensor with
    that Python float rounds it; below ``BIG`` a masked source, at ``BIG``
    in the twin, is in no ball. Raises on any other input before it builds
    or launches anything, and then counts no launch."""
    where = "ball_query_cuda"
    named = {"xyz": xyz, "xyz_mask": xyz_mask, "new_xyz": new_xyz}
    for name, x in (("xyz", xyz), ("new_xyz", new_xyz)):
        if x.ndim != 3 or x.shape[-1] != 3:
            raise ValueError(f"{where} needs (B, rows, 3) {name}, got {tuple(x.shape)}")
        if x.dtype != torch.float32:
            raise ValueError(f"{where} needs float32 {name}, got {x.dtype}")
    if xyz_mask.dtype != torch.bool:
        raise ValueError(f"{where} needs a bool xyz_mask, got {xyz_mask.dtype}")
    b, n = xyz.shape[0], xyz.shape[1]
    if tuple(xyz_mask.shape) != (b, n) or new_xyz.shape[0] != b:
        raise ValueError(f"{where}: xyz {tuple(xyz.shape)}, xyz_mask {tuple(xyz_mask.shape)} "
                         f"and new_xyz {tuple(new_xyz.shape)} disagree")
    if not 1 <= nsample <= BALL_QUERY_MAX_SAMPLE:
        raise ValueError(f"{where} takes 1 <= nsample <= {BALL_QUERY_MAX_SAMPLE}, "
                         f"got {nsample}")
    if n < 1 or b > BALL_QUERY_MAX_BATCH:
        raise ValueError(f"{where} needs N >= 1 and B <= {BALL_QUERY_MAX_BATCH}, "
                         f"got B={b}, N={n}")
    r2 = float(np.float32(radius * radius))
    if not r2 < BIG:
        raise ValueError(f"{where} needs radius² below {BIG:g}, got radius {radius}")
    for name, x in named.items():
        if not x.is_contiguous():
            raise ValueError(f"{where} needs contiguous {name}")
    check_cuda(where, named)
    m = new_xyz.shape[1]
    idx = torch.empty((b, m, nsample), dtype=torch.int64, device=xyz.device)
    empty = torch.empty((b, m), dtype=torch.bool, device=xyz.device)
    if idx.numel() == 0:
        return idx, empty
    lib = _lib()
    with torch.cuda.device(xyz.device):
        err = lib.ball_query_launch(xyz.data_ptr(), xyz_mask.data_ptr(), new_xyz.data_ptr(), b,
                                    n, m, r2, nsample, idx.data_ptr(), empty.data_ptr(),
                                    torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ball_query kernel launch failed: "
                           f"{lib.ball_query_error_string(err).decode()}")
    ball_query_cuda.launches += 1
    trace.count("ball_query.kernel", 1)
    return idx, empty


# kernel launches since the last reset
ball_query_cuda.launches = 0


def ball_query_cross_cuda(xyz, new_xyz):
    """The kernel's cross term alone: (B, M, N) float32, entry (b, i, j)
    the product of centre i and source j as ``csrc/ball_query.cu`` rounds it
    (cuBLAS's K = 3 order on the H100), for xyz (B, N, 3) and new_xyz (B, M,
    3), contiguous float32 CUDA tensors on one device, B and M at most
    65535. Where ``torch.matmul(new_xyz, xyz.transpose(-1, -2))``, the cross
    term of ``pairwise_dist2``, parts from it, cuBLAS has changed its order,
    and the kernel's memberships no longer follow the plain twin's."""
    where = "ball_query_cross_cuda"
    for name, x in (("xyz", xyz), ("new_xyz", new_xyz)):
        if x.ndim != 3 or x.shape[-1] != 3 or x.dtype != torch.float32:
            raise ValueError(f"{where} needs (B, rows, 3) float32 {name}, got "
                             f"{tuple(x.shape)} {x.dtype}")
    b, n, m = xyz.shape[0], xyz.shape[1], new_xyz.shape[1]
    if new_xyz.shape[0] != b or b > BALL_QUERY_MAX_BATCH or m > BALL_QUERY_MAX_BATCH:
        raise ValueError(f"{where}: xyz {tuple(xyz.shape)} and new_xyz "
                         f"{tuple(new_xyz.shape)} disagree or exceed the grid")
    check_cuda(where, {"xyz": xyz, "new_xyz": new_xyz})
    out = torch.empty((b, m, n), dtype=torch.float32, device=xyz.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(xyz.device):
        err = lib.ball_query_cross_launch(xyz.data_ptr(), new_xyz.data_ptr(), b, n, m,
                                          out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ball_query cross launch failed: "
                           f"{lib.ball_query_error_string(err).decode()}")
    return out


@torch.no_grad()
def ball_query_masked(xyz, xyz_mask, new_xyz, radius: float, nsample: int):
    """xyz (B, N, 3), xyz_mask (B, N), new_xyz (B, M, 3) → (idx (B, M,
    nsample) int64, empty (B, M)). CUDA tensors go to the kernel
    (``ball_query_cuda``, made contiguous first), CPU tensors to the plain
    twin. Traced as the span ``ball_query``, with the counters
    ``ball_query.pairs`` (the B·M·N source-centre pairs) and
    ``ball_query.centres`` (B·M), both known from the shapes, and
    ``ball_query.kernel`` (the kernel's launches)."""
    b, m, n = new_xyz.shape[0], new_xyz.shape[1], xyz.shape[1]
    trace.count("ball_query.pairs", b * m * n)
    trace.count("ball_query.centres", b * m)
    with trace.span("ball_query"):
        if xyz.is_cuda:
            return ball_query_cuda(xyz.contiguous(), xyz_mask.contiguous(),
                                   new_xyz.contiguous(), radius, nsample)
        if xyz.device.type == "cpu":
            return ball_query_masked_plain(xyz, xyz_mask, new_xyz, radius, nsample)
        raise ValueError(f"ball_query_masked: unsupported device {xyz.device}")


def query_and_group_masked(xyz, xyz_mask, features, new_xyz, radius: float, nsample: int,
                           use_xyz: bool = True):
    """Group ``features`` (B, N, C) of the in-ball sources around each centre:
    (B, M, nsample, 3 + C) with the offsets to the centre first (or (B, M,
    nsample, C) without ``use_xyz``), zeros for an empty ball; and the empty
    flags (B, M)."""
    idx, empty = ball_query_masked(xyz, xyz_mask, new_xyz, radius, nsample)
    return _group(xyz, features, new_xyz, idx, empty, use_xyz)


VOXEL_QUERY_CHUNK = 4096  # queries per pass: a pass holds (B, chunk, (2R + 1)³) lookups


@torch.no_grad()
def voxel_query(new_xyz, voxel_keys, voxel_centers, radius: float, nsample: int,
                max_range: int, shape_zyx, point_cloud_range, voxel_size):
    """Up to ``nsample`` active voxels within ``radius`` of each query, from
    the (2R + 1)³ voxel neighbourhood (R = ``max_range``) of the query's
    cell: one ``torch.searchsorted`` of every neighbour's key into the sorted
    keys (key = (z·ny + y)·nx + x; padding keys lie past every cell), as the
    JAX package's ``voxel_query`` does.

    new_xyz (B, M, 3); voxel_keys (B, V) sorted; voxel_centers (B, V, 3);
    ``shape_zyx`` (nz, ny, nx) and ``voxel_size`` of this scale. The hits
    in the radius keep the first ``nsample`` by offset order (z outermost,
    x innermost); empty slots repeat the first hit. Returns (idx (B, M,
    nsample) int64 into V, empty (B, M): no hit, idx 0). The centres are
    gathered by each lookup's position, never broadcast to (B, M, V), and
    the queries go in chunks of ``VOXEL_QUERY_CHUNK``."""
    b, m, _ = new_xyz.shape
    v = voxel_keys.shape[1]
    nz, ny, nx = shape_zyx
    dev = new_xyz.device
    pcr = torch.tensor(point_cloud_range[:3], dtype=torch.float32, device=dev)
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    r = int(max_range)
    span = torch.arange(-r, r + 1, device=dev)
    offs = torch.stack(torch.meshgrid(span, span, span, indexing="ij"), dim=-1).reshape(-1, 3)
    dims = torch.tensor([nz, ny, nx], device=dev)
    col = torch.arange(offs.shape[0], device=dev, dtype=torch.float32)
    keys = voxel_keys.to(torch.int64).contiguous()
    idx_out, empty_out = [], []
    for lo in range(0, m, VOXEL_QUERY_CHUNK):
        q = new_xyz[:, lo:lo + VOXEL_QUERY_CHUNK]
        mq = q.shape[1]
        cell = torch.floor((q - pcr) / vs).to(torch.int64).flip(-1)  # (B, mq, 3) zyx
        cand = cell[:, :, None, :] + offs  # (B, mq, K, 3)
        inb = ((cand >= 0) & (cand < dims)).all(-1)
        ck = (cand[..., 0] * ny + cand[..., 1]) * nx + cand[..., 2]
        pos = torch.searchsorted(keys, ck.reshape(b, -1)).clamp_max(v - 1)
        hit = inb & (keys.gather(1, pos).reshape(ck.shape) == ck)
        c = voxel_centers.gather(1, pos[..., None].expand(-1, -1, 3)).reshape(*ck.shape, 3)
        d = c - q[:, :, None, :]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        hit &= d2 < radius * radius
        score = torch.where(hit, -col, float("-inf"))
        top_scores, top_off = torch.topk(score, nsample, dim=-1)  # lowest offsets first
        valid = torch.isfinite(top_scores)
        sel = pos.reshape(ck.shape).gather(2, top_off)
        any_hit = valid[..., :1]
        idx_out.append(torch.where(any_hit, torch.where(valid, sel, sel[..., :1]), 0))
        empty_out.append(~any_hit[..., 0])
    return torch.cat(idx_out, dim=1), torch.cat(empty_out, dim=1)
