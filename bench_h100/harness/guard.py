"""Which modules a run may load.

The timed program is ``modest_tpu_torch``; the JAX package it was ported
from (``modest_tpu``) and JAX itself must never load in a run. Names are
compared by their whole top-level part, since ``modest_tpu_torch`` begins
with ``modest_tpu``. The reference must not import the port at all.
"""
from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "modest_tpu"})
PORT = "modest_tpu_torch"


def forbidden_loaded(modules=None) -> list[str]:
    """The top-level names of ``sys.modules`` (or ``modules``) in FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & FORBIDDEN)


def imported_tops(path: Path) -> set[str]:
    """Top-level module names that ``path``'s import statements name."""
    tree = ast.parse(path.read_text(), filename=str(path))
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def reference_offenders(reference_dir: Path) -> dict[str, list[str]]:
    """Reference files that import the port, the JAX package or JAX."""
    bad = {}
    for path in sorted(reference_dir.glob("*.py")):
        hit = sorted(imported_tops(path) & (FORBIDDEN | {PORT}))
        if hit:
            bad[path.name] = hit
    return bad


def reference_modules_clean(reference_package: str) -> list[str]:
    """Loaded reference modules whose globals hold an object of the port."""
    bad = []
    for name, module in list(sys.modules.items()):
        if not name.startswith(reference_package + ".") or module is None:
            continue
        for value in vars(module).values():
            owner = getattr(value, "__module__", None) or getattr(value, "__name__", None)
            if isinstance(owner, str) and owner.split(".")[0] in FORBIDDEN | {PORT}:
                bad.append(f"{name}: {owner}")
    return bad
