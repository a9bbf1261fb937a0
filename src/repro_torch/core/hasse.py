"""Hasse graph of the subset partial order over T-bit patterns (Sec. 2.3).

Nodes are integers in [0, 2^T). ``a <= b`` iff ``a & b == a`` (bitwise
subset). The Hasse graph keeps only covering edges: ``a -> b`` iff
``b = a | (1 << i)`` for a bit ``i`` not in ``a`` (distance 1 = one bit flip).

* **prefix** of b: any a with a <= b (a provides the reused partial sum).
* **suffix** of a: any b with a <= b.
* **level** of a node = popcount (its Hamming weight).
* **distance**(a, b) = level(b) - level(a) for a <= b.

All tables are precomputed once per T and cached — they are tiny
(2^T x T ints) and shared by the scoreboard, the cost model and the tests.
"""
from __future__ import annotations

import functools
import numpy as np

__all__ = [
    "popcount",
    "levels",
    "hamming_order",
    "covering_prefixes",
    "covering_suffixes",
    "is_prefix",
    "distance",
    "lsb_prefix",
]


def popcount(x: np.ndarray) -> np.ndarray:
    """Vectorised popcount for uint arrays."""
    x = np.asarray(x, dtype=np.uint64)
    c = np.zeros(x.shape, dtype=np.int64)
    while True:
        c += (x & 1).astype(np.int64)
        x = x >> np.uint64(1)
        if not x.any():
            break
    return c


@functools.lru_cache(maxsize=None)
def levels(t: int) -> np.ndarray:
    """Level (popcount) of every node in a T-bit Hasse graph. (2^T,) int64."""
    return popcount(np.arange(1 << t, dtype=np.uint64))


@functools.lru_cache(maxsize=None)
def hamming_order(t: int) -> np.ndarray:
    """All 2^T nodes sorted by level (stable within a level; Sec. 3.1).

    The paper's Alg. 1 line 3 traverses nodes level-by-level; ties carry no
    ordering requirement. Stable argsort keeps integer order within levels,
    matching the worked example in Fig. 5.
    """
    return np.argsort(levels(t), kind="stable").astype(np.int64)


@functools.lru_cache(maxsize=None)
def covering_prefixes(t: int) -> np.ndarray:
    """(2^T, T) int64: node with bit i cleared, or -1 if bit i not set."""
    n = 1 << t
    nodes = np.arange(n, dtype=np.int64)[:, None]
    bits = 1 << np.arange(t, dtype=np.int64)[None, :]
    has = (nodes & bits) != 0
    return np.where(has, nodes & ~bits, -1)


@functools.lru_cache(maxsize=None)
def covering_suffixes(t: int) -> np.ndarray:
    """(2^T, T) int64: node with bit i set, or -1 if bit i already set."""
    n = 1 << t
    nodes = np.arange(n, dtype=np.int64)[:, None]
    bits = 1 << np.arange(t, dtype=np.int64)[None, :]
    free = (nodes & bits) == 0
    return np.where(free, nodes | bits, -1)


def is_prefix(a: int | np.ndarray, b: int | np.ndarray) -> np.ndarray:
    """Whether ``a`` is a (non-strict) prefix of ``b`` in the partial order."""
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    return (a & b) == a


def distance(a: int | np.ndarray, b: int | np.ndarray) -> np.ndarray:
    """Level difference for a <= b (undefined otherwise; caller checks)."""
    return popcount(b) - popcount(a)


def lsb_prefix(x: np.ndarray) -> np.ndarray:
    """The canonical doubling prefix: x with its lowest set bit cleared.

    This is the distance-1 prefix used by the dense-LUT kernel
    (DESIGN.md §2): LUT[x] = LUT[x & (x-1)] + input_row[lsb(x)].
    """
    x = np.asarray(x, dtype=np.int64)
    return x & (x - 1)
