"""The port's launch scripts: ``scripts/torch_multihost_train.sh`` and
``scripts/torch_slurm_train.sh``.

Each takes its JAX counterpart's arguments in the same order and runs
``python -m modest_tpu_torch.cli.train`` with ``--launcher manual`` or
``--launcher slurm``. With stub ``python`` and ``srun`` first on ``PATH``,
which print their argv, the command lines are read back and parsed by the
port's ``cli/train.py``.
"""
import os
import subprocess
from pathlib import Path

import pytest

from modest_tpu_torch.cli import train as train_cli
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = {"multihost": REPO / "scripts" / "torch_multihost_train.sh",
           "slurm": REPO / "scripts" / "torch_slurm_train.sh"}
CFG = "configs/models/lyft_models/second_dynamic_obj.yaml"
MODULE = ["-m", "modest_tpu_torch.cli.train"]


@pytest.fixture
def stub_path(tmp_path):
    """A PATH whose ``python`` and ``srun`` print their name and argv, one
    word a line."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    for name in ("python", "srun"):
        stub = bin_dir / name
        stub.write_text(f'#!/bin/sh\nprintf "%s\\n" {name} "$@"\n')
        stub.chmod(0o755)
    return f"{bin_dir}{os.pathsep}{os.environ['PATH']}"


def run_script(name, args, path):
    return subprocess.run(["bash", str(SCRIPTS[name]), *args], cwd=REPO, capture_output=True,
                          text=True, timeout=60, env={**os.environ, "PATH": path})


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_script_parses(name):
    subprocess.run(["bash", "-n", str(SCRIPTS[name])], check=True, timeout=60)
    assert os.access(SCRIPTS[name], os.X_OK)


@pytest.mark.parametrize("name,args", [("multihost", []), ("multihost", ["0", "2", "h:1"]),
                                       ("slurm", [])])
def test_a_missing_argument_prints_the_usage(name, args, stub_path):
    out = run_script(name, args, stub_path)
    assert out.returncode != 0
    assert f"usage: torch_{name}_train.sh" in out.stderr
    assert out.stdout == ""  # nothing was started


def test_multihost_runs_the_port_with_launcher_manual(stub_path):
    out = run_script("multihost", ["1", "2", "host0:12996", CFG, "--batch_size", "4",
                                   "--set", "OPTIMIZATION.LR", "4.8e-4"], stub_path)
    assert out.returncode == 0, out.stderr
    argv = out.stdout.splitlines()
    assert argv == ["python", *MODULE, "--cfg_file", CFG, "--launcher", "manual",
                    "--coordinator", "host0:12996", "--num_processes", "2", "--process_id",
                    "1", "--batch_size", "4", "--set", "OPTIMIZATION.LR", "4.8e-4"]
    args, cfg = train_cli.parse_config(argv[3:])
    assert (args.launcher, args.coordinator, args.num_processes, args.process_id) == (
        "manual", "host0:12996", 2, 1)
    assert args.batch_size == 4 and cfg.OPTIMIZATION.LR == 4.8e-4
    assert cfg.MODEL.NAME == "SECONDNet"


@pytest.mark.parametrize("args,tag,extra", [([CFG], "default", []),
                                            ([CFG, "run7"], "run7", []),
                                            ([CFG, "run7", "--epochs", "3"], "run7",
                                             ["--epochs", "3"])])
def test_slurm_runs_the_port_under_srun(args, tag, extra, stub_path):
    out = run_script("slurm", args, stub_path)
    assert out.returncode == 0, out.stderr
    argv = out.stdout.splitlines()
    assert argv == ["srun", "python", *MODULE, "--cfg_file", CFG, "--extra_tag", tag,
                    "--launcher", "slurm", *extra]
    parsed, _ = train_cli.parse_config(argv[4:])
    assert (parsed.launcher, parsed.extra_tag) == ("slurm", tag)
    assert parsed.epochs == (3 if extra else None)
