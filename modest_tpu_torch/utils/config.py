"""Hierarchical config: dict with attribute access + YAML loading.

The port's own copy of ``modest_tpu/utils/config.py`` (``Config`` and
``cfg_from_yaml_file`` with ``_BASE_CONFIG_`` inheritance). PyYAML is
imported only when a YAML file is read, so code that builds a model from the
Python dicts in ``modest_tpu_torch.configs`` needs no YAML parser.
"""
from __future__ import annotations

import collections.abc
import copy
import re
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


# The implicit resolvers of PyYAML's SafeLoader (YAML 1.1), copied from
# PyYAML's yaml/resolver.py: a plain scalar that matches one of them is typed,
# in this order; any other plain scalar is a string.
_YAML_BOOL = re.compile(r"""^(?:yes|Yes|YES|no|No|NO
                    |true|True|TRUE|false|False|FALSE
                    |on|On|ON|off|Off|OFF)$""", re.X)
_YAML_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_YAML_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_YAML_NULL = re.compile(r"""^(?: ~
                    |null|Null|NULL
                    | )$""", re.X)
_YAML_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
# the escapes of a double-quoted scalar (PyYAML's yaml/scanner.py)
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n", "v": "\x0b",
            "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "\\": "\\", "/": "/",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}
_INDICATORS = "-?:,[]{}#&*!|>'\"%@`"  # no plain scalar starts with one (but see _plain)
_FLOW_STOP = ",?[]{}"                 # end a plain scalar inside a flow collection


def _unsupported(text: str, why: str):
    return ValueError(f"override value {text!r}: {why}; quote it to pass a string")


def _resolve(text: str, plain: str):
    """A plain scalar typed as PyYAML's constructors type it."""
    if _YAML_BOOL.match(plain):
        return plain.lower() in ("yes", "true", "on")
    if _YAML_FLOAT.match(plain):
        v = plain.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        if ":" in v:  # base 60
            return sign * sum(float(p) * 60 ** e for e, p in enumerate(reversed(v.split(":"))))
        return sign * float(v)
    if _YAML_INT.match(plain):
        v = plain.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        if ":" in v:  # base 60
            return sign * sum(int(p) * 60 ** e for e, p in enumerate(reversed(v.split(":"))))
        return sign * int(v)
    if _YAML_NULL.match(plain):
        return None
    if _YAML_TIMESTAMP.match(plain) or plain in ("<<", "="):
        raise _unsupported(text, "YAML reads a timestamp, merge key or value key here")
    return plain


class _ValueParser:
    """The part of YAML a one-line override value uses: plain, single- and
    double-quoted scalars, and flow sequences and mappings of them."""

    def __init__(self, text: str):
        self.text, self.s, self.i = text, text.strip(" "), 0

    def error(self, why: str):
        return _unsupported(self.text, why)

    def peek(self, ahead: int = 0) -> str:
        j = self.i + ahead
        return self.s[j] if j < len(self.s) else ""

    def skip_spaces(self):
        while self.peek() == " ":
            self.i += 1

    def parse(self):
        s = self.s
        if not all(ch.isprintable() for ch in s):
            raise self.error("tabs, line breaks and control characters are not read")
        if not s:
            return None
        if s.startswith(("---", "...", "#")):
            raise self.error("YAML reads a document marker or a comment here")
        if s[:1] in ("[", "{", "'", '"'):
            value = self.node(flow=False)
            self.skip_spaces()
            if self.i != len(s):
                raise self.error(f"unexpected {s[self.i:]!r} after the value")
            return value
        return self.plain(flow=False)

    def node(self, flow: bool):
        ch = self.peek()
        if ch == "[":
            return self.sequence()
        if ch == "{":
            return self.mapping()
        if ch in ("'", '"'):
            return self.quoted()
        return self.plain(flow)

    def plain(self, flow: bool):
        s, start = self.s, self.i
        ch, nxt = self.peek(), self.peek(1)
        # PyYAML's check_plain: '-' (and, outside flow collections, '?' and
        # ':') may start a plain scalar when a non-space follows
        starts = ch != "" and (ch not in _INDICATORS or (
            nxt not in ("", " ") and (ch == "-" or (not flow and ch in "?:"))))
        if flow and ch == "-" and nxt in _FLOW_STOP:
            starts = False
        if not starts:
            raise self.error(f"YAML does not read {s[start:] or 'an empty entry'!r} as a plain "
                             f"scalar")
        j = start
        while j < len(s):
            c = s[j]
            after = s[j + 1] if j + 1 < len(s) else ""
            if c == ":" and (after in ("", " ") or (flow and after in _FLOW_STOP)):
                if not flow:
                    raise self.error("YAML reads a mapping here")
                break
            if c == "#" and s[j - 1] == " ":
                raise self.error("YAML reads a comment here")
            if flow and c in _FLOW_STOP:
                break
            j += 1
        self.i = j
        return _resolve(self.text, s[start:j].rstrip(" "))

    def quoted(self):
        s, quote = self.s, self.peek()
        j, out = self.i + 1, []
        while True:
            if j >= len(s):
                raise self.error("an unclosed quote")
            c = s[j]
            if c == quote:
                if quote == "'" and s[j + 1:j + 2] == "'":
                    out.append("'")
                    j += 2
                    continue
                self.i = j + 1
                return "".join(out)
            if quote == '"' and c == "\\":
                e = s[j + 1:j + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    j += 2
                    continue
                n = _ESCAPE_CODES.get(e)
                digits = s[j + 2:j + 2 + n] if n else ""
                if not n or len(digits) != n or any(d not in "0123456789abcdefABCDEF"
                                                    for d in digits):
                    raise self.error(f"an unknown escape \\{e}")
                out.append(chr(int(digits, 16)))
                j += 2 + n
                continue
            out.append(c)
            j += 1

    def sequence(self):
        self.i += 1
        items = []
        while True:
            self.skip_spaces()
            if self.peek() == "]":
                self.i += 1
                return items
            items.append(self.node(flow=True))
            self.skip_spaces()
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "]":
                raise self.error(f"unexpected {self.s[self.i:]!r} in a flow sequence")

    def mapping(self):
        self.i += 1
        out = {}
        while True:
            self.skip_spaces()
            if self.peek() == "}":
                self.i += 1
                return out
            key = self.node(flow=True)
            if isinstance(key, (list, dict)):
                raise self.error("a collection as a mapping key")
            self.skip_spaces()
            value = None
            if self.peek() == ":":  # inside a flow collection any ':' here is the value indicator
                self.i += 1
                self.skip_spaces()
                if self.peek() not in (",", "}"):
                    value = self.node(flow=True)
                    self.skip_spaces()
            out[key] = value
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "}":
                raise self.error(f"unexpected {self.s[self.i:]!r} in a flow mapping")


def parse_value(text: str):
    """A ``key=value`` override's value, read as ``yaml.safe_load`` reads it,
    without a YAML parser: YAML 1.1's null, bool, int (bases 2, 8, 10, 16 and
    60, underscores) and float (a dot needed; ``.inf``, ``.nan``) plain
    scalars, quoted strings, and nested flow sequences and mappings of them.
    A value that YAML would read as anything else (a timestamp, an anchor, a
    tag, a block collection, a comment) raises ``ValueError``."""
    return _ValueParser(text).parse()


def cfg_from_kv_overrides(overrides, config: Config) -> Config:
    """Apply hydra-style ``a.b.c=value`` overrides; a bool keeps its type and
    a list must stay a list, as in ``modest_tpu/utils/config.py::_coerce``."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override {item!r} must be key=value")
        full_key, text = item.split("=", 1)
        keys = full_key.split(".")
        d = config
        for sub in keys[:-1]:
            if sub not in d:
                d[sub] = Config()
            d = d[sub]
        old, new = d.get(keys[-1]), parse_value(text)
        if old is not None and new is not None:
            if isinstance(old, bool):
                new = bool(new)
            elif isinstance(old, (list, tuple)) and not isinstance(new, (list, tuple)):
                raise ValueError(f"expected list for override, got {text!r}")
        d[keys[-1]] = new
    return config


def resolve_interpolations(cfg: Config) -> Config:
    """Resolve ``${a.b.c}`` references against the root config until a fixed
    point; a whole-string reference keeps the referenced value's type."""
    pattern = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")

    def lookup(path):
        d = cfg
        for part in path.split("."):
            d = d[part]
        return d

    def resolve_str(s):
        m = pattern.fullmatch(s)
        if m:
            return lookup(m.group(1))
        return pattern.sub(lambda mm: str(lookup(mm.group(1))), s)

    def walk(node):
        changed = False
        items = node.items() if isinstance(node, Config) else enumerate(node)
        for k, v in list(items):
            if isinstance(v, str) and pattern.search(v):
                node[k] = resolve_str(v)
                changed = True
            elif isinstance(v, (Config, list)):
                changed |= walk(v)
        return changed

    for _ in range(10):
        if not walk(cfg):
            break
    return cfg
