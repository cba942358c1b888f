"""Hierarchical config: dict with attribute access + YAML loading.

The port's own copy of ``modest_tpu/utils/config.py`` (``Config`` and
``cfg_from_yaml_file`` with ``_BASE_CONFIG_`` inheritance). PyYAML is
imported only when a YAML file is read, so code that builds a model from the
Python dicts in ``modest_tpu_torch.configs`` needs no YAML parser.
"""
from __future__ import annotations

import collections.abc
import copy
from pathlib import Path


class Config(dict):
    """dict with attribute access; nested dicts are converted recursively."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        for k, v in (d or {}).items():
            self[k] = v
        for k, v in kwargs.items():
            self[k] = v

    @staticmethod
    def _wrap(v):
        if isinstance(v, Config):
            return v
        if isinstance(v, collections.abc.Mapping):
            return Config(v)
        if isinstance(v, list):
            return [Config._wrap(x) for x in v]
        if isinstance(v, tuple):
            return tuple(Config._wrap(x) for x in v)
        return v

    def __setitem__(self, k, v):
        super().__setitem__(k, Config._wrap(v))

    def __setattr__(self, k, v):
        self[k] = v

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k) from None

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self):
        def unwrap(v):
            if isinstance(v, Config):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return type(v)(unwrap(x) for x in v)
            return v

        return unwrap(self)


def _load_yaml(path: Path):
    import yaml  # lazy: the GPU host may have no PyYAML

    with open(path) as f:
        return yaml.safe_load(f)


def _merge_new_config(config: Config, new_config: dict, base_dir: Path) -> Config:
    """Recursive merge; ``_BASE_CONFIG_`` is loaded first, then overridden."""
    if "_BASE_CONFIG_" in new_config:
        base_path = Path(new_config["_BASE_CONFIG_"])
        if not base_path.is_absolute():
            cand = base_dir / base_path
            base_path = cand if cand.exists() else Path.cwd() / base_path
        _merge_new_config(config, _load_yaml(base_path), base_path.parent)

    for key, val in new_config.items():
        if key == "_BASE_CONFIG_":
            continue
        if isinstance(val, dict):
            if key not in config or not isinstance(config[key], dict):
                config[key] = Config()
            _merge_new_config(config[key], val, base_dir)
        else:
            config[key] = val
    return config


def cfg_from_yaml_file(cfg_file, config: Config | None = None) -> Config:
    config = Config() if config is None else config
    cfg_file = Path(cfg_file)
    _merge_new_config(config, _load_yaml(cfg_file) or {}, cfg_file.parent)
    return config
