"""Batching and device feeding — port of ``modest_tpu/data/loader.py``.

Every sample already has a fixed shape, so a batch is a dense dict of numpy
arrays: points (B, N, 3+C) f32, gt_boxes (B, MAX_GT, W) f32 zero-padded, W the
widest sample's (8, or 10 with nuScenes' velocities), and CaDDN's camera
items stacked (images (B, H, W, 3), depth_maps, the calibration matrices,
gt_boxes2d (B, MAX_GT, 4) zero-padded).

With ``num_workers > 0`` batches are built ahead of use by worker
processes (the augmentation path is many small numpy calls and holds the
interpreter lock, so threads would not overlap it). Workers start with the
``spawn`` method, so a process that holds a CUDA context never forks; each
receives the dataset once, pickled. Each batch is built under a seed derived
from (loader seed, epoch, batch index), so the batches are the same for any
worker count, 0 included. ``prefetch_to_device`` copies a batch's arrays
into pinned memory and onto the device without blocking, one batch ahead.

In a process group (``parallel/``) ``build_dataloader`` gives each process
its shard of every global batch: all shuffle one order and process p keeps
every nproc-th sample from p, in batches of the global batch / nproc.
"""
from __future__ import annotations

import collections
import multiprocessing as mp

import numpy as np


MAX_GT_DEFAULT = 64
# the camera items (CaDDN), zero-padded to max_gt rows for gt_boxes2d
CAMERA_KEYS = ("images", "depth_maps", "trans_lidar_to_cam", "trans_cam_to_img", "gt_boxes2d")

# a worker process's dataset and pad size ({} in the parent; set by _worker_init)
_WORKER = {}


def _worker_init(dataset, max_gt):
    _WORKER["dataset"] = dataset
    _WORKER["max_gt"] = max_gt


def _worker_build(task):
    seed, idx = task
    np.random.seed(seed)
    ds, max_gt = _WORKER["dataset"], _WORKER["max_gt"]
    return collate_batch([ds[int(i)] for i in idx], max_gt)


def collate_batch(samples: list[dict], max_gt: int = MAX_GT_DEFAULT) -> dict:
    batch = {}
    batch["frame_id"] = [s["frame_id"] for s in samples]
    if "calib" in samples[0]:
        batch["calib"] = [s["calib"] for s in samples]
    if "image_shape" in samples[0]:
        batch["image_shape"] = [s["image_shape"] for s in samples]
    if "metadata" in samples[0]:  # nuScenes token / Waymo context, used by eval writers
        batch["metadata"] = [s["metadata"] for s in samples]
    batch["points"] = np.stack([s["points"] for s in samples]).astype(np.float32)
    for key in CAMERA_KEYS[:-1]:  # CaDDN's items, stacked when the dataset gives them
        if key in samples[0]:
            batch[key] = np.stack([s[key] for s in samples]).astype(np.float32)
    if "gt_boxes2d" in samples[0]:
        b2d = np.zeros((len(samples), max_gt, 4), np.float32)
        for i, s in enumerate(samples):
            n = min(len(s["gt_boxes2d"]), max_gt)
            b2d[i, :n] = s["gt_boxes2d"][:n]
        batch["gt_boxes2d"] = b2d
    if "gt_boxes" in samples[0]:
        width = max((s["gt_boxes"].shape[1] for s in samples), default=8)
        gt = np.zeros((len(samples), max_gt, width), np.float32)
        for i, s in enumerate(samples):
            n = min(len(s["gt_boxes"]), max_gt)
            if len(s["gt_boxes"]) > max_gt:
                import warnings

                warnings.warn(
                    f"collate_batch: frame has {len(s['gt_boxes'])} gt boxes, "
                    f"truncating to max_gt={max_gt} — raise --max_gt to keep "
                    f"all labels (extra boxes are silently unsupervised)")
            gt[i, :n] = s["gt_boxes"][:n]
        batch["gt_boxes"] = gt
    batch["batch_size"] = len(samples)
    return batch


class DataLoader:
    """Epoch loader with deterministic shuffling and optional batch
    prefetch by worker processes (``num_workers`` workers, up to twice as
    many batches in flight, yielded in order).

    ``use_procs``: None (default) uses the workers when they are asked for
    and the host has more than one core; True/False forces the pool or the
    inline path (the batches are the same either way)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool, max_gt: int = MAX_GT_DEFAULT,
                 drop_last: bool = True, seed: int = 0, num_workers: int = 0,
                 process_shard: tuple | None = None, use_procs: bool | None = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.max_gt = max_gt
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.num_workers = num_workers
        # (process_id, num_processes): every process shuffles the SAME global
        # order (shared seed) then keeps its interleaved slice — the
        # DistributedSampler contract; batch_size is the per-process batch
        self.process_shard = process_shard
        self.use_procs = use_procs

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _local_count(self):
        n = len(self.dataset)
        if self.process_shard is not None:
            pid, nproc = self.process_shard
            n = len(range(pid, n, nproc))
        return n

    def __len__(self):
        if self.drop_last:
            # the whole global batches: every process takes as many batches
            # (a process-sharded JAX loader gives the first processes one
            # more when the split is not a multiple of the processes)
            nproc = self.process_shard[1] if self.process_shard is not None else 1
            return len(self.dataset) // (self.batch_size * nproc)
        n = self._local_count()
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(order)
        if self.process_shard is not None:
            pid, nproc = self.process_shard
            order = order[pid::nproc]
        stop = len(self) * self.batch_size if self.drop_last else len(order)
        for start in range(0, stop, self.batch_size):
            idx = order[start : start + self.batch_size]
            if len(idx) < self.batch_size:  # never with drop_last (``stop``)
                # pad the tail batch by wrapping (keeps static shapes); the
                # eval loop de-dupes by frame_id
                idx = np.concatenate([idx, order[: self.batch_size - len(idx)]])
            yield idx

    def _seed_for(self, batch_i: int) -> int:
        # per-batch augmentation stream: identical output for any worker
        # count; no rank in it, so every process's batch i starts from one
        # seed (as in the JAX package; pcdet's workers differ by rank)
        return (self.seed * 1_000_003 + self.epoch * 100_019 + batch_i) % (2**31)

    def _build(self, idx, batch_i: int):
        np.random.seed(self._seed_for(batch_i))
        return collate_batch([self.dataset[int(i)] for i in idx], self.max_gt)

    def _get_pool(self):
        """One persistent pool of ``spawn`` workers, made at first use and
        reused across epochs."""
        if getattr(self, "_pool", None) is None:
            ctx = mp.get_context("spawn")
            self._pool = ctx.Pool(self.num_workers, initializer=_worker_init,
                                  initargs=(self.dataset, self.max_gt))
        return self._pool

    def close(self):
        pool = getattr(self, "_pool", None)
        if pool is not None:
            pool.terminate()
            pool.join()
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __iter__(self):
        use_procs = self.use_procs
        if use_procs is None:  # one core cannot overlap worker processes with anything
            use_procs = (mp.cpu_count() or 1) > 1
        use_procs = use_procs and self.num_workers > 0
        if not use_procs:
            for bi, idx in enumerate(self._batch_indices()):
                yield self._build(idx, bi)
            return
        # a bounded number in flight, so results never pile up faster than
        # the device takes them
        depth = 2 * self.num_workers
        pool = self._get_pool()
        pending: collections.deque = collections.deque()
        for bi, idx in enumerate(self._batch_indices()):
            pending.append(
                pool.apply_async(_worker_build, ((self._seed_for(bi), idx),)))
            if len(pending) >= depth:
                yield pending.popleft().get()
        while pending:
            yield pending.popleft().get()


def batch_to_device(batch: dict, device) -> dict:
    """The batch with its ``points``, ``gt_boxes`` and camera items as
    tensors on ``device``: copied through pinned memory without blocking on
    a CUDA device, wrapped without a copy on the CPU."""
    import torch  # here, so the spawned workers that import this module skip torch

    dev = torch.device(device)
    out = dict(batch)
    for key in ("points", "gt_boxes", *CAMERA_KEYS):
        if key not in batch:
            continue
        t = torch.from_numpy(batch[key])
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        out[key] = t
    return out


def prefetch_to_device(loader, device):
    """Yield the loader's batches on ``device`` (``batch_to_device``), each
    copy started one batch ahead of its use."""
    ahead = None
    for batch in loader:
        if ahead is not None:
            yield ahead
        ahead = batch_to_device(batch, device)
    if ahead is not None:
        yield ahead


def build_dataloader(dataset_cfg, class_names, batch_size, root_path=None, training=True,
                     logger=None, total_epochs=1, merge_all_iters_to_one_epoch=False,
                     max_gt: int = MAX_GT_DEFAULT, num_workers: int = 0):
    """The dataset of ``dataset_cfg`` and its loader of global batches of
    ``batch_size``; in a process group, this process's shard of each."""
    from ..parallel.mesh import world  # here: spawned workers import this module

    name = dataset_cfg.get("DATASET", "KittiDataset")
    if name == "NuScenesDataset":
        from .nuscenes_dataset import NuScenesDataset as dataset_cls
    elif name == "WaymoDataset":
        from .waymo_dataset import WaymoDataset as dataset_cls
    else:
        from .kitti_dataset import KittiDataset as dataset_cls
    dataset = dataset_cls(dataset_cfg=dataset_cfg, class_names=class_names, training=training,
                          root_path=root_path, logger=logger)
    if merge_all_iters_to_one_epoch:
        dataset.merge_all_iters_to_one_epoch(True, total_epochs)
    # with a process group each process loads its shard of every global batch
    pid, nproc = world()
    process_shard = None
    if nproc > 1:
        if batch_size % nproc:
            raise ValueError(f"global batch_size {batch_size} must divide evenly across "
                             f"{nproc} processes — a silent floor would change the "
                             "effective batch/LR schedule")
        process_shard = (pid, nproc)
        batch_size //= nproc
    loader = DataLoader(dataset, batch_size, shuffle=training, max_gt=max_gt,
                        drop_last=training, num_workers=num_workers,
                        process_shard=process_shard)
    return dataset, loader
