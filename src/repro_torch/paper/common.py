"""Shared helpers for the paper sections (port of ``benchmarks/common.py``)."""
from __future__ import annotations

import time

import numpy as np

__all__ = ["timed", "synth_weights", "emit"]


def timed(fn, *args, reps: int = 3, warmup: int = 1):
    for _ in range(warmup):
        fn(*args)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    dt = (time.perf_counter() - t0) / reps
    return out, dt * 1e6                      # microseconds


def synth_weights(n: int, k: int, bits: int, seed: int = 0) -> np.ndarray:
    """Gaussian weights quantized to int-``bits`` — stand-in for extracted
    LLaMA tensors. Justified by the paper's own Sec. 5.9 finding that
    random and real data behave within a few percent for TranSparsity."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, k))
    scale = np.abs(w).max() / ((1 << (bits - 1)) - 1)
    return np.clip(np.round(w / scale), -(1 << (bits - 1)),
                   (1 << (bits - 1)) - 1).astype(np.int64)


def emit(name: str, us: float, derived: str):
    print(f"{name},{us:.2f},{derived}")
