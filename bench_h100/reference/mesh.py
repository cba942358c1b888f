"""The single-process forms of the port's data-parallel helpers
(``parallel/mesh.py``): without a process group each is the identity."""
from __future__ import annotations


def world() -> tuple[int, int]:
    return 0, 1


def distributed() -> bool:
    return False


def global_sum(x):
    return x


def global_batch(b: int) -> int:
    return b


def rank_rows(x, b: int):
    return x
