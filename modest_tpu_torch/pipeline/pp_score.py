"""Ephemerality (PP) score over historical traversals.

Port of ``modest_tpu/pipeline/pp_score.py``. Per origin frame, every
neighbouring traversal's frames are aligned into the first neighbouring
traversal's first frame (``get_relative_pose``); each origin point's
neighbours within ``radius`` are counted in each traversal's combined cloud;
PP = entropy of the per-traversal counts over log(#traversals).

Both frame entry points count through ``ops/radius_count.py`` (x-sorted
pools, windowed exact ``d² ≤ r²`` test): on a CUDA device the hand-written
kernel, on the CPU its plain twin. The JAX package's CPU route (the
approximate ``|x|²+|y|²−2x·y`` expansion) and its uint16 query upload are TPU
workarounds and are not ported.
"""
from __future__ import annotations

import collections
import os.path as osp
import threading

import numpy as np
import torch

from ..ops.radius_count import BN, PAD, compute_tile_windows, radius_count_sorted
from ..utils.device import StageTimer, resolve_device, stage
from ..utils.kitti_io import load_velo_scan
from ..utils.pose import (KITTI2NU_LYFT, KITTI2NU_NUSC, get_relative_pose, load_oxts_pose,
                          transform_points)


def compute_ephe_score(count: np.ndarray, ephe_type: str = "entropy") -> np.ndarray:
    """Normalized entropy over per-traversal counts, in float64."""
    if ephe_type != "entropy":
        raise NotImplementedError(ephe_type)
    count = np.asarray(count, np.float64)
    n = count.shape[1]
    P = count / (count.sum(axis=1, keepdims=True) + 1e-8)
    return (-P * np.log(P + 1e-8)).sum(axis=1) / np.log(n)


def remove_center(ptc, x_range=(-1.15, 1.75), y_range=(-0.65, 0.65)):
    """Crop the ego-vehicle footprint (nuScenes)."""
    mask = (
        (ptc[:, 0] < x_range[1])
        & (ptc[:, 0] >= x_range[0])
        & (ptc[:, 1] < y_range[1])
        & (ptc[:, 1] >= y_range[0])
    )
    return ptc[~mask]


class TraversalIndex:
    """Loads track_list + valid_idx metadata and the per-frame pose files.

    track_list: list over sequences of lists of global frame ids.
    valid_idx: {origin_idx: (origin_seq, origin_frame, [(seq_id, frame_indices), ...])}
    """

    def __init__(self, data_root, track_list, valid_idx, nusc: bool = False):
        self.data_root = str(data_root)
        self.track_list = track_list
        self.valid_idx = valid_idx
        self.kitti2nu = KITTI2NU_NUSC if nusc else KITTI2NU_LYFT
        self.nusc = nusc
        oxts = osp.join(self.data_root, "oxts")
        l2e = osp.join(self.data_root, "l2e")
        self.poses = [[load_oxts_pose(osp.join(oxts, f"{i:06d}.txt")) for i in seq]
                      for seq in track_list]
        self.l2es = [[np.load(osp.join(l2e, f"{i:06d}.npy")) for i in seq] for seq in track_list]

    def _velo(self, global_idx: int) -> np.ndarray:
        return load_velo_scan(osp.join(self.data_root, "velodyne", f"{global_idx:06d}.bin"))[:, :3]

    def relative_pose(self, fixed, seq_id: int, frame: int) -> np.ndarray:
        """4x4 map from frame ``frame`` of sequence ``seq_id`` into ``fixed``,
        a (seq_id, frame) pair."""
        return get_relative_pose(
            fixed_l2e=self.l2es[fixed[0]][fixed[1]], fixed_ego=self.poses[fixed[0]][fixed[1]],
            query_l2e=self.l2es[seq_id][frame], query_ego=self.poses[seq_id][frame],
            kitti2nu=self.kitti2nu)

    def combined_traversals(self, origin_idx: int):
        """({seq_id: (M_i, 3) aligned cloud}, origin trans_mat 4x4), all in
        the frame of the FIRST neighbouring traversal's first frame."""
        _, _, neighbors = self.valid_idx[origin_idx]
        fixed = (neighbors[0][0], neighbors[0][1][0])
        combined = {}
        for seq_id, indices in neighbors:
            parts = []
            for frame in indices:
                ptc = self._velo(self.track_list[seq_id][frame])
                if self.nusc:
                    ptc = remove_center(ptc)
                parts.append(transform_points(ptc, self.relative_pose(fixed, seq_id, frame))
                             .astype(np.float32))
            combined[seq_id] = np.concatenate(parts)
        origin_seq, origin_frame, _ = self.valid_idx[origin_idx]
        return combined, self.relative_pose(fixed, origin_seq, origin_frame)

    def origin_cloud(self, origin_idx: int) -> np.ndarray:
        origin_seq, origin_frame, _ = self.valid_idx[origin_idx]
        return self._velo(self.track_list[origin_seq][origin_frame])


def _pad_queries(origin_ptc: np.ndarray, device) -> torch.Tensor:
    """(n, 3) → (n_pad, 3) float32 on ``device``, n_pad the next multiple of
    BN (at least BN, so an empty cloud still makes one tile), pad rows at
    1e9 so they sort to the end."""
    n = origin_ptc.shape[0]
    n_pad = max(BN, -(-n // BN) * BN)
    q = np.full((n_pad, 3), PAD, np.float32)
    q[:n] = origin_ptc[:, :3]
    return torch.from_numpy(q).to(device)


def _sorted_inputs(q_pad: torch.Tensor, x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                   radius: float, timer: StageTimer | None = None):
    """The radius count's inputs: x-sorted queries (3, Nq), x-sorted pools
    (T, 3, M) and tile windows (T, Nq / BN, 2), plus the query order.
    q_pad (Nq, 3) has pad rows at 1e9; x, y, z (T, M) are pool coordinates
    with pad points at 1e9."""
    with stage(timer, "sort"):
        sx, perm = torch.sort(x, dim=1, stable=True)
        t_sorted = torch.stack([sx, torch.gather(y, 1, perm), torch.gather(z, 1, perm)], dim=1)
        order = torch.argsort(q_pad[:, 0], stable=True)
        q_s = q_pad[order].T.contiguous()  # (3, Nq)
    with stage(timer, "windows"):
        lohi = compute_tile_windows(q_s[0], sx, torch.tensor(radius, dtype=torch.float32,
                                                             device=q_pad.device))
    return q_s, t_sorted, lohi, order


def radius2(radius: float) -> float:
    """r² as the float32 product the count compares with."""
    return float(np.float32(radius) * np.float32(radius))


def _sorted_pool_counts(q_pad: torch.Tensor, x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                        radius: float, timer: StageTimer | None = None) -> torch.Tensor:
    """(Nq, T) int32 counts in the queries' own order (see _sorted_inputs)."""
    q_s, t_sorted, lohi, order = _sorted_inputs(q_pad, x, y, z, radius, timer)
    with stage(timer, "count"):
        counts = radius_count_sorted(q_s, t_sorted, lohi, radius2(radius))  # (T, Nq)
    out = torch.empty_like(counts)
    out[:, order] = counts
    return out.T


class FrameCache:
    """Raw velodyne frames kept on ``device``, padded to one size, in a
    bounded LRU (consecutive origin frames share most of their neighbour
    frames, so each scan is uploaded once and aligned on the device).

    The pad size ``m_pad`` (the next power of two of the first frame's size,
    at least ``chunk``) is chosen under the lock, so two pipeline threads
    loading differently sized first frames still share one size. Evicted
    entries are only dropped from the map: another thread may still hold
    them."""

    def __init__(self, load_fn, device="cuda", chunk: int = 8192, max_frames: int = 512):
        self.load_fn = load_fn
        self.device = resolve_device(device)
        self.m_pad: int | None = None  # set by the first frame
        self.chunk = chunk
        self.max_frames = max_frames
        self._frames: "collections.OrderedDict[int, tuple]" = collections.OrderedDict()
        self._lock = threading.Lock()

    def frame(self, gid: int):
        """(points (m_pad, 3) float32, mask (m_pad,) bool) on the device."""
        with self._lock:
            if gid in self._frames:
                self._frames.move_to_end(gid)
                return self._frames[gid]
        pts = np.asarray(self.load_fn(gid), np.float32)[:, :3]
        with self._lock:
            if self.m_pad is None:
                self.m_pad = max(self.chunk, 1 << max(pts.shape[0] - 1, 0).bit_length())
            m_pad = self.m_pad
        if pts.shape[0] > m_pad:
            raise ValueError(f"frame {gid} has {pts.shape[0]} points, above the cache's {m_pad}")
        buf = np.zeros((m_pad, 3), np.float32)
        buf[: pts.shape[0]] = pts
        mask = np.zeros(m_pad, bool)
        mask[: pts.shape[0]] = True
        entry = (torch.from_numpy(buf).to(self.device), torch.from_numpy(mask).to(self.device))
        with self._lock:
            if gid in self._frames:  # raced: another thread filled it
                self._frames.move_to_end(gid)
                return self._frames[gid]
            while len(self._frames) >= self.max_frames:
                self._frames.popitem(last=False)
            self._frames[gid] = entry
            return entry

    def __len__(self):
        return len(self._frames)


def _neighbors(index: TraversalIndex, origin_idx: int, limit_traversals: int):
    _, _, neighbors = index.valid_idx[origin_idx]
    if limit_traversals > 1:
        neighbors = neighbors[:limit_traversals]
    return neighbors


def _cached_pools(index: TraversalIndex, cache: FrameCache, origin_idx: int,
                  limit_traversals: int = -1, timer: StageTimer | None = None):
    """(q_pad (Nq, 3), (x, y, z) (T, M) pools, n) for one origin frame, on the
    cache's device: cached frames grouped per traversal in slabs of the
    largest traversal's frame count (dummy frames masked out), transformed
    into the first traversal's frame, pad and masked points at 1e9."""
    dev = cache.device
    neighbors = _neighbors(index, origin_idx, limit_traversals)
    fixed = (neighbors[0][0], neighbors[0][1][0])
    t_count = len(neighbors)
    fmax = max(len(indices) for _, indices in neighbors)
    with stage(timer, "frames"):
        rows, masks, rts = [], [], []
        for seq_id, indices in neighbors:
            slab = []
            for frame in indices:
                fr, fm = cache.frame(index.track_list[seq_id][frame])
                slab.append((fr, fm, index.relative_pose(fixed, seq_id, frame)))
            while len(slab) < fmax:
                slab.append((slab[0][0], torch.zeros_like(slab[0][1]), np.eye(4, dtype=np.float32)))
            for fr, fm, rel in slab:
                rows.append(fr)
                masks.append(fm)
                rts.append(rel[:3])
        frames = torch.stack(rows)                      # (F, Mp, 3)
        fmask = torch.stack(masks)                      # (F, Mp)
        rt = torch.from_numpy(np.stack(rts).astype(np.float32)).to(dev)  # (F, 3, 4)
        origin_seq, origin_frame, _ = index.valid_idx[origin_idx]
        origin_ptc = transform_points(index.origin_cloud(origin_idx),
                                      index.relative_pose(fixed, origin_seq, origin_frame))
        q_pad = _pad_queries(origin_ptc, dev)
    with stage(timer, "transform"):
        # R[:, 0]·x + R[:, 1]·y + R[:, 2]·z + t in float32 elementwise steps:
        # the card and the CPU get the same points
        fx, fy, fz = frames[..., 0], frames[..., 1], frames[..., 2]
        coords = []
        for i in range(3):
            r = rt[:, i, :, None]                                      # (F, 4, 1)
            c = r[:, 0] * fx + r[:, 1] * fy + r[:, 2] * fz + r[:, 3]
            coords.append(torch.where(fmask, c, PAD).reshape(t_count, -1))
    return q_pad, coords, origin_ptc.shape[0]


def pp_counts_cached_sorted(index: TraversalIndex, cache: FrameCache, origin_idx: int,
                            radius: float, limit_traversals: int = -1,
                            timer: StageTimer | None = None):
    """((n, T) int64 counts, n) for one origin frame from cached frames."""
    q_pad, coords, n = _cached_pools(index, cache, origin_idx, limit_traversals, timer)
    counts = _sorted_pool_counts(q_pad, *coords, radius, timer)
    with stage(timer, "download"):
        out = counts[:n].cpu().numpy().astype(np.int64)
    return out, n


def pp_score_for_frame_cached(index: TraversalIndex, cache: FrameCache, origin_idx: int,
                              radius: float, limit_traversals: int = -1,
                              timer: StageTimer | None = None) -> np.ndarray:
    """PP score of one origin frame from cached frames, on the cache's device."""
    counts, _ = pp_counts_cached_sorted(index, cache, origin_idx, radius, limit_traversals, timer)
    with stage(timer, "entropy"):
        return compute_ephe_score(counts).astype(np.float32)


def pp_score_for_frame(index: TraversalIndex, origin_idx: int, radius: float,
                       limit_traversals: int = -1, add_random_noise: float = 0.0,
                       rng: np.random.RandomState | None = None, device="cuda") -> np.ndarray:
    """PP score of one origin frame from the combined clouds (the path that
    can perturb the origin cloud with ``add_random_noise``)."""
    dev = resolve_device(device)
    combined, trans_mat = index.combined_traversals(origin_idx)
    origin_ptc = transform_points(index.origin_cloud(origin_idx), trans_mat)
    if add_random_noise > 0:
        rng = rng or np.random.RandomState()
        noise = rng.randn(3)
        noise /= np.linalg.norm(noise)
        noise *= add_random_noise * rng.uniform()
        origin_ptc = origin_ptc + noise.reshape(1, 3)
    traversals = list(combined.values())
    if limit_traversals > 1:
        traversals = traversals[:limit_traversals]
    m = max(8192, -(-max(t.shape[0] for t in traversals) // 8192) * 8192)
    pools = np.full((len(traversals), m, 3), PAD, np.float32)
    for i, t in enumerate(traversals):
        pools[i, : t.shape[0]] = t[:, :3]
    pools_t = torch.from_numpy(pools).to(dev)
    counts = _sorted_pool_counts(_pad_queries(origin_ptc.astype(np.float32), dev),
                                 pools_t[..., 0], pools_t[..., 1], pools_t[..., 2], radius)
    n = origin_ptc.shape[0]
    return compute_ephe_score(counts[:n].cpu().numpy()).astype(np.float32)
