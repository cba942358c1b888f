"""Multi-process initialization and result merging — port of
``modest_tpu/parallel/multihost.py`` (reference pcdet
common_utils.init_dist_slurm / init_dist_pytorch / merge_results_dist).

One process per device. ``init_multihost`` reads SLURM's environment as the
JAX package does, joins a ``torch.distributed`` process group and returns the
process's device; ``spawn_local`` starts N such processes on this host (the
counterpart of a JAX mesh over N local devices). The backend follows the
devices: NCCL when every process has a card of its own, gloo on the CPU and
for CUDA processes that share a card (NCCL refuses two ranks on one device).
Nothing retries one backend with another.
"""
from __future__ import annotations

import datetime
import os
import pickle
import socket
import time
from pathlib import Path

import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .mesh import barrier, world


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None, device="cuda") -> torch.device:
    """Join the process group of ``num_processes`` processes and return this
    process's device. A no-op for one process (or none given), which returns
    ``device`` itself.

    Under SLURM the arguments come from the environment (SLURM_NTASKS,
    SLURM_PROCID, the first host of SLURM_STEP_NODELIST as coordinator on the
    port MODEST_TPU_COORD_PORT, default 12996), as the JAX package reads
    them, mirroring the reference's init_dist_slurm:130-155."""
    if num_processes is None and "SLURM_NTASKS" in os.environ:
        num_processes = int(os.environ["SLURM_NTASKS"])
        process_id = int(os.environ["SLURM_PROCID"])
        if coordinator_address is None:
            nodelist = os.environ.get("SLURM_STEP_NODELIST", "localhost")
            first = _first_slurm_host(nodelist)
            port = os.environ.get("MODEST_TPU_COORD_PORT", "12996")
            coordinator_address = f"{first}:{port}"
    if num_processes in (None, 1):
        return resolve_device(device)
    if coordinator_address is None or process_id is None:
        raise ValueError(f"{num_processes} processes need a coordinator address and a "
                         "process id (--coordinator, --process_id)")
    local_rank = int(os.environ.get("SLURM_LOCALID", process_id))
    return start_process_group(coordinator_address, num_processes, process_id, device,
                               local_rank=local_rank)


def start_process_group(coordinator_address: str, num_processes: int, process_id: int,
                        device="cuda", local_rank: int | None = None,
                        timeout: datetime.timedelta | None = None) -> torch.device:
    """``torch.distributed.init_process_group`` for any world size, 1
    included, its rendezvous the TCP store at ``coordinator_address``
    ("host:port"; process 0 serves it, as a ``tcp://`` init method would).
    A CUDA process takes ``cuda:(local_rank % visible cards)``, ``local_rank``
    defaulting to ``process_id``; ``device`` "cpu" keeps it on the CPU.
    Returns the device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = process_id if local_rank is None else local_rank
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    host, port = coordinator_address.rsplit(":", 1)
    # every process learns every other's (host, card) from the rendezvous
    # store, so all pick one backend: NCCL needs a card per process
    store = dist.TCPStore(host, int(port), num_processes, is_master=process_id == 0,
                          timeout=timeout or datetime.timedelta(minutes=10))
    store.set(f"device/{process_id}", f"{socket.gethostname()}/{dev}")
    seats = [store.get(f"device/{r}").decode() for r in range(num_processes)]
    shared = len(set(seats)) < num_processes
    backend = "gloo" if dev.type == "cpu" or shared else "nccl"
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, store=store, rank=process_id, world_size=num_processes,
                            **kwargs)
    return dev


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def free_port() -> int:
    """A TCP port on this host that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawned(rank: int, fn, nprocs: int, coordinator: str, args):
    torch.set_num_threads(1)
    fn(rank, nprocs, coordinator, *args)


def spawn_local(fn, nprocs: int, device, args=()) -> None:
    """Run ``fn(rank, nprocs, "127.0.0.1:<port>", *args)`` in ``nprocs``
    processes started by ``torch.multiprocessing`` (spawn), one device
    each, and wait for them all; a process that fails raises here. On CUDA
    there must be a card per process: two never share one silently."""
    if torch.device(device).type == "cuda" and torch.cuda.device_count() < nprocs:
        raise RuntimeError(f"{nprocs} devices asked for, but only "
                           f"{torch.cuda.device_count()} CUDA cards are visible")
    resolve_device(device)
    coordinator = f"127.0.0.1:{free_port()}"
    torch.multiprocessing.spawn(_spawned, args=(fn, nprocs, coordinator, args), nprocs=nprocs,
                                join=True)


def _first_slurm_host(nodelist: str) -> str:
    """First hostname of a SLURM nodelist, handling dashed hostnames and
    bracketed ranges: "tpu-vm-[001-004,007],other" → "tpu-vm-001"
    (the reference shells out to `scontrol show hostname`,
    common_utils.py:137; parse locally to avoid the dependency)."""
    import re

    m = re.match(r"^([^\[,]+)\[([^\]]+)\]", nodelist)
    if m:
        prefix, ranges = m.group(1), m.group(2)
        first = ranges.split(",")[0].split("-")[0]
        return prefix + first
    return nodelist.split(",")[0]


def shard_indices_for_process(n_items: int, process_id: int | None = None,
                              num_processes: int | None = None):
    """Per-process slice of the dataset (DistributedSampler equivalent)."""
    rank, size = world()
    pid = rank if process_id is None else process_id
    nproc = size if num_processes is None else num_processes
    return list(range(pid, n_items, nproc))


def merge_results_dist(part_results: list, tmpdir, part_id: int | None = None,
                       num_parts: int | None = None):
    """Merge per-process eval results through a shared filesystem
    (reference common_utils.merge_results_dist:194-216).

    Every process dumps ``result_part_{pid}.pkl`` into ``tmpdir``; process 0
    waits for all parts, concatenates them in interleaved-shard order (the
    inverse of shard_indices_for_process) and returns the full list; other
    processes return None.
    """
    rank, size = world()
    pid = rank if part_id is None else part_id
    nproc = size if num_parts is None else num_parts
    tmpdir = Path(tmpdir)
    tmpdir.mkdir(parents=True, exist_ok=True)
    # atomic publish: a reader can never observe a partially-written pickle
    final_path = tmpdir / f"result_part_{pid}.pkl"
    tmp_path = tmpdir / f".result_part_{pid}.pkl.tmp"
    with open(tmp_path, "wb") as f:
        pickle.dump(part_results, f)
    os.replace(tmp_path, final_path)
    if part_id is None and size > 1:
        # real multi-process run: barrier so process 0 can also safely
        # DELETE parts after merging (reference uses dist.barrier())
        barrier()
    if pid != 0:
        return None
    parts = []
    for i in range(nproc):
        path = tmpdir / f"result_part_{i}.pkl"
        deadline = time.time() + 600
        while not path.exists():
            if time.time() > deadline:
                raise TimeoutError(f"missing eval part {path}")
            time.sleep(2)
        with open(path, "rb") as f:
            parts.append(pickle.load(f))
        path.unlink()  # never merge a stale part from a previous run
    # inverse interleave: item j of part i was global index i + j*nproc
    total = sum(len(p) for p in parts)
    merged = [None] * total
    for i, p in enumerate(parts):
        for j, r in enumerate(p):
            merged[i + j * nproc] = r
    return merged
