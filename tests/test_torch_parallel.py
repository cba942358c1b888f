"""The port's multi-process helpers against the JAX package's, in one process
on the CPU: SLURM parsing (the arguments JAX's ``init_multihost`` hands to
``jax.distributed.initialize`` against those the port hands to its process
group), the first SLURM host, the process shards, ``merge_results_dist``
with explicit parts of unequal lengths, the process-sharded loader's
batches with augmentation on, ``build_dataloader``'s split of the global
batch, and the refusal of ``--num_devices`` beyond the visible cards.
"""
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from modest_tpu.data import loader as jloader
from modest_tpu.parallel import multihost as jmultihost
from modest_tpu_torch.cli import test as test_cli
from modest_tpu_torch.cli import train as train_cli
from modest_tpu_torch.data import loader as tloader
from modest_tpu_torch.parallel import mesh
from modest_tpu_torch.parallel import multihost

from test_torch_data import _batches, roots  # noqa: F401  (the module fixture)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
SLURM_KEYS = ("SLURM_NTASKS", "SLURM_PROCID", "SLURM_STEP_NODELIST", "SLURM_LOCALID",
              "MODEST_TPU_COORD_PORT")


@pytest.mark.parametrize("env,kwargs", [
    ({"SLURM_NTASKS": "4", "SLURM_PROCID": "2", "SLURM_STEP_NODELIST": "tpu-vm-[001-004,007],x",
      "MODEST_TPU_COORD_PORT": "23456"}, {}),
    ({"SLURM_NTASKS": "2", "SLURM_PROCID": "1", "SLURM_STEP_NODELIST": "node-a,node-b"}, {}),
    ({"SLURM_NTASKS": "2", "SLURM_PROCID": "0"}, {"coordinator_address": "10.0.0.1:999"}),
    ({"SLURM_NTASKS": "1", "SLURM_PROCID": "0"}, {}),
    ({}, {"coordinator_address": "h:1", "num_processes": 3, "process_id": 2}),
    ({}, {}),
])
def test_init_multihost_reads_slurm_as_jax(monkeypatch, env, kwargs):
    for key in SLURM_KEYS:
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    want, got = [], []
    monkeypatch.setattr(jax.distributed, "initialize", lambda **kw: want.append(kw))
    monkeypatch.setattr(multihost, "start_process_group",
                        lambda address, n, pid, device, local_rank: got.append(
                            {"coordinator_address": address, "num_processes": n,
                             "process_id": pid}) or torch.device("cpu"))
    joined = jmultihost.init_multihost(**kwargs)
    assert multihost.init_multihost(**kwargs, device="cpu") == torch.device("cpu")
    assert got == want and bool(got) == joined


@pytest.mark.parametrize("nodelist", ["tpu-vm-[001-004,007],other", "a-b-c", "h1,h2",
                                      "n[7]", "gpu[12-15]"])
def test_first_slurm_host_is_jax(nodelist):
    assert multihost._first_slurm_host(nodelist) == jmultihost._first_slurm_host(nodelist)


@pytest.mark.parametrize("n,pid,nproc", [(11, 0, 3), (11, 2, 3), (4, 1, 2), (1, 1, 2)])
def test_shard_indices_are_jax(n, pid, nproc):
    assert (multihost.shard_indices_for_process(n, pid, nproc)
            == jmultihost.shard_indices_for_process(n, pid, nproc))
    assert multihost.shard_indices_for_process(n) == jmultihost.shard_indices_for_process(n)


def test_merge_results_dist_is_jax(tmp_path):
    """11 items over 3 parts (4, 4, 3), written by parts 2, 1, then 0: part
    0 gets JAX's merge in the original order and the part files are gone;
    the other parts get None."""
    items = [{"frame_id": f"{i:06d}", "v": np.arange(i)} for i in range(11)]
    parts = [items[p::3] for p in range(3)]
    merged = {}
    for side, fn in (("jax", jmultihost.merge_results_dist),
                     ("torch", multihost.merge_results_dist)):
        d = tmp_path / side
        assert fn(parts[2], d, part_id=2, num_parts=3) is None
        assert fn(parts[1], d, part_id=1, num_parts=3) is None
        merged[side] = fn(parts[0], d, part_id=0, num_parts=3)
        assert not list(d.iterdir())
    assert [m["frame_id"] for m in merged["torch"]] == [m["frame_id"] for m in merged["jax"]]
    assert [m["frame_id"] for m in merged["torch"]] == [it["frame_id"] for it in items]
    for a, b in zip(merged["torch"], merged["jax"]):
        np.testing.assert_array_equal(a["v"], b["v"])


@pytest.mark.parametrize("pid", [0, 1])
def test_process_shard_batches_are_jax(roots, pid):  # noqa: F811
    """Each of two processes' batches (1 a process, augmentation on, two
    epochs) under one np.random seed: JAX's frame ids, points and gt boxes."""
    want = _batches(jloader, roots["jax"], True, seed=666, process_shard=(pid, 2), batch_size=1)
    got = _batches(tloader, roots["torch"], True, seed=666, process_shard=(pid, 2),
                   batch_size=1)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g["frame_id"] == w["frame_id"]
        np.testing.assert_array_equal(g["points"], w["points"])
        np.testing.assert_array_equal(g["gt_boxes"], w["gt_boxes"])
    other = _batches(tloader, roots["torch"], True, seed=666, process_shard=(1 - pid, 2),
                     batch_size=1)
    for epoch in range(2):  # the two shards split each epoch's frames
        ids = [b["frame_id"][0] for b in got[3 * epoch:3 * epoch + 3]
               + other[3 * epoch:3 * epoch + 3]]
        assert sorted(ids) == [f"{i:06d}" for i in range(6)]


class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"frame_id": i, "points": np.zeros((1, 4), np.float32)}


def test_every_process_takes_as_many_train_batches():
    """7 samples, 2 processes of 1: JAX's sharded loader gives process 0
    four batches and process 1 three (the processes of one step would wait
    for each other); the port gives each the 3 whole global batches, and
    keeps the wrap-padded tail of an eval shard."""
    jlens = [len(jloader.DataLoader(_Items(7), 1, shuffle=True, process_shard=(p, 2)))
             for p in (0, 1)]
    assert jlens == [4, 3]
    shards = [tloader.DataLoader(_Items(7), 1, shuffle=True, process_shard=(p, 2))
              for p in (0, 1)]
    assert [len(s) for s in shards] == [len(list(s)) for s in shards] == [3, 3]
    seen = [b["frame_id"][0] for s in shards for b in s]
    assert len(set(seen)) == 6
    evals = [tloader.DataLoader(_Items(7), 2, shuffle=False, drop_last=False,
                                process_shard=(p, 2)) for p in (0, 1)]
    assert [[b["frame_id"] for b in s] for s in evals] == [[[0, 2], [4, 6]], [[1, 3], [5, 1]]]


def test_build_dataloader_splits_the_global_batch(monkeypatch):
    from modest_tpu_torch.configs import POINTRCNN_DYNAMIC_OBJ_DATA_CONFIG
    from modest_tpu_torch.data import kitti_dataset
    from modest_tpu_torch.utils.config import Config

    monkeypatch.setattr(mesh, "world", lambda: (1, 2))
    monkeypatch.setattr(kitti_dataset.KittiDataset, "__init__", lambda self, **kw: None)
    cfg = Config(POINTRCNN_DYNAMIC_OBJ_DATA_CONFIG)
    _, loader = tloader.build_dataloader(cfg, ["Dynamic"], 4, training=True)
    assert (loader.batch_size, loader.process_shard) == (2, (1, 2))
    with pytest.raises(ValueError, match="divide evenly across 2 processes"):
        tloader.build_dataloader(cfg, ["Dynamic"], 3, training=True)


def test_helpers_are_the_identity_without_a_group():
    x = torch.arange(6.0).reshape(3, 2).requires_grad_(True)
    assert mesh.world() == (0, 1) and mesh.global_batch(3) == 3
    assert mesh.global_sum(x) is x and mesh.rank_rows(x, 2) is x
    assert torch.equal(mesh.global_mean(x), x.mean())
    mesh.reduce_gradients([x])  # nothing to reduce: the gradient stays as it was
    assert x.grad is None


@pytest.mark.parametrize("cli", ["train", "test"])
def test_num_devices_beyond_the_cards_raises(monkeypatch, tmp_path, cli):
    """``--num_devices 2`` on CUDA with one visible card raises before any
    process starts; two processes never share a card silently."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    started = []
    monkeypatch.setattr(torch.multiprocessing, "spawn", lambda *a, **kw: started.append(a))
    cfg = str(REPO / "configs/models/lyft_models/pointrcnn_dynamic_obj.yaml")
    with pytest.raises(RuntimeError, match="2 devices asked for, but only 1 CUDA cards"):
        if cli == "train":
            train_cli.main(["--cfg_file", cfg, "--num_devices", "2", "--output_dir",
                            str(tmp_path)])
        else:
            test_cli.main(["--cfg_file", cfg, "--ckpt_dir", str(tmp_path), "--num_devices", "2"])
    assert not started
