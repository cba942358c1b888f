"""Shared CLI plumbing for the pipeline entry points.

Port of ``modest_tpu/cli/common.py``: a default config plus hydra-style
``key=value`` overrides, a ``data_paths`` config group and sharding via
``total_part``/``part``. The configs come from the dicts in
``modest_tpu_torch/configs.py``, so no YAML parser is needed; ``display_args``
prints the config as ``save_config`` writes it.
"""
from __future__ import annotations

import argparse
import copy
import os
import sys

import numpy as np

from ..configs import PIPELINE_CONFIGS, PIPELINE_DATA_PATHS
from ..utils.config import Config, cfg_from_kv_overrides, config_text, resolve_interpolations


def eprint(*args, **kwargs):
    print(*args, file=sys.stderr, **kwargs)


def load_pipeline_config(config_name: str, overrides: list[str]) -> Config:
    cfg = Config(copy.deepcopy(PIPELINE_CONFIGS[config_name]))
    # the data_paths group is chosen before the other overrides apply, so
    # `data_paths=nusc` on the command line selects the group
    group = [o for o in overrides if o.split("=", 1)[0] == "data_paths"]
    rest = [o for o in overrides if o.split("=", 1)[0] != "data_paths"]
    if group:
        cfg.data_paths = group[-1].split("=", 1)[1]
    if isinstance(cfg.get("data_paths"), str):
        cfg.data_paths = Config(copy.deepcopy(PIPELINE_DATA_PATHS[cfg.data_paths]))
    cfg_from_kv_overrides(rest, cfg)
    resolve_interpolations(cfg)
    return cfg


def make_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("overrides", nargs="*", help="key=value config overrides (hydra-style)")
    return p


def shard_idx_list(idx_list, total_part: int, part: int):
    idx_list = np.array(list(idx_list))
    if total_part > 1:
        idx_list = np.array_split(idx_list, total_part)[part]
    return idx_list


def display_args(name: str, cfg: Config):
    eprint(f"========== {name} info ==========")
    eprint("host: {}".format(os.getenv("HOSTNAME")))
    eprint(config_text(cfg))
    eprint("=" * (26 + len(name)))


def progress(done: int, total: int, label: str):
    """One progress line on stderr (the port does not depend on tqdm)."""
    eprint(f"\r{label}: {done}/{total}", end="\n" if done >= total else "", flush=True)
