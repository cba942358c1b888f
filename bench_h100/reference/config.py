"""A dict with attribute access, as the port's ``utils/config.py::Config``."""
from __future__ import annotations

import collections.abc


class Config(dict):
    def __init__(self, d=None):
        super().__init__()
        for k, v in (d or {}).items():
            self[k] = v

    @staticmethod
    def _wrap(v):
        if isinstance(v, Config):
            return v
        if isinstance(v, collections.abc.Mapping):
            return Config(v)
        if isinstance(v, (list, tuple)):
            return type(v)(Config._wrap(x) for x in v)
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

    def to_dict(self):
        def unwrap(v):
            if isinstance(v, Config):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return type(v)(unwrap(x) for x in v)
            return v
        return unwrap(self)
