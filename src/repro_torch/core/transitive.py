"""Lossless transitive GEMM — public entry points, engine-backed (port of
``repro.core.transitive``, numpy as there).

``transitive_gemm`` executes ``W @ X`` for an S-bit integer weight
``W (N, K)`` and integer input ``X (K, M)`` through the batched multi-tile
engine (core/engine.py): all ``K//T`` scoreboards are built in one call and
the Scoreboard forest is executed level-synchronously across tiles. It must
be **bit-exact** against ``W.astype(i64) @ X.astype(i64)`` — the paper's
lossless claim (Sec. 2.1).

The original row-at-a-time walker lives on as core/transitive_ref.py; it is
the oracle that this engine, the CUDA kernels and the quantized
integer-matmul path are held against.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.engine import BatchedTransitiveEngine
from repro_torch.core.patterns import tile_stats
from repro_torch.core.transitive_ref import execute_tile, transitive_gemm_ref

__all__ = ["transitive_gemm", "transitive_gemm_stats", "execute_tile",
           "transitive_gemm_ref"]


def transitive_gemm(w: np.ndarray, x: np.ndarray, bits: int, t: int,
                    max_distance: int = 4) -> np.ndarray:
    """Full transitive GEMM: int-S ``w (N, K)`` @ int ``x (K, M)`` → int64."""
    eng = BatchedTransitiveEngine(bits=bits, t=t, max_distance=max_distance)
    return eng(np.asarray(w), np.asarray(x))


def transitive_gemm_stats(w: np.ndarray, x: np.ndarray, bits: int, t: int):
    """transitive_gemm + op counts; returns (out, dict of totals).

    The op counts come straight off the plan's batched scoreboard — the
    plan and the executed result share one ScoreboardInfo.
    """
    eng = BatchedTransitiveEngine(bits=bits, t=t)
    plan = eng.plan(np.asarray(w))
    st = tile_stats(plan.si)
    out = eng.run(plan, np.asarray(x))
    totals = {k_: int(getattr(st, k_).sum()) for k_ in
              ("ppe_ops", "ape_ops", "dense_ops", "bit_ops")}
    totals["density"] = max(totals["ppe_ops"], totals["ape_ops"]) / totals["dense_ops"]
    return out, totals
