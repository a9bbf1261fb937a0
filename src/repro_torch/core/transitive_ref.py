"""Row-at-a-time transitive GEMM walker — the port's bit-exactness oracle
(port of ``repro.core.transitive_ref``, numpy as there).

This is the seed's execution path: one k-tile and one Hasse node at a
time, in plain Python loops, mirroring the hardware's per-node dataflow
(Fig. 8) as literally as possible:

  for each k-tile of width T:
    psum[node] = psum[prefix(node)] + sum(X rows of diff bits)   # PPE
    out[row]  += sign * 2^shift * psum[node(row)]                # APE + shift

It is deliberately slow and deliberately clear: the batched engine
(core/engine.py), the CUDA kernels and the quantized integer-matmul path
are held against this walker *and* against plain
``W.astype(i64) @ X.astype(i64)`` (the paper's lossless claim, Sec. 2.1).

Do not optimise this module. Optimisations go in core/engine.py.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import bitslice, hasse
from repro_torch.core.scoreboard import dynamic_scoreboard, ScoreboardInfo

__all__ = ["transitive_gemm_ref", "execute_tile"]


def execute_tile(si: ScoreboardInfo, tile_idx: int, x_tile: np.ndarray) -> np.ndarray:
    """Compute psums (2^T, M) for one tile by walking the prefix forest.

    Args:
      si: scoreboard for a batch of tiles.
      tile_idx: which tile.
      x_tile: (T, M) integer input rows for this k-tile.

    Returns: (2^T, M) int64 psum table (only executed nodes are valid).
    """
    t = si.t
    size = 1 << t
    m = x_tile.shape[1]
    psum = np.zeros((size, m), dtype=np.int64)
    order = hasse.hamming_order(t)
    exec_counts = si.exec_counts[tile_idx]
    outlier = si.outlier[tile_idx]
    prefix = si.prefix[tile_idx]
    x64 = x_tile.astype(np.int64)
    for idx in order:
        if idx == 0 or exec_counts[idx] == 0:
            continue
        if outlier[idx]:
            # dispatched at the end via direct accumulation
            bits = [b for b in range(t) if (idx >> b) & 1]
            psum[idx] = x64[bits].sum(0)
            continue
        pre = int(prefix[idx])
        assert pre >= 0, f"executed node {idx} lacks a prefix"
        diff = idx ^ pre
        assert diff and hasse.is_prefix(pre, idx), (idx, pre)
        bits = [b for b in range(t) if (diff >> b) & 1]
        psum[idx] = psum[pre] + x64[bits].sum(0)
    return psum


def transitive_gemm_ref(w: np.ndarray, x: np.ndarray, bits: int, t: int,
                        max_distance: int = 4) -> np.ndarray:
    """Full transitive GEMM: int-S ``w (N, K)`` @ int ``x (K, M)`` → int64.

    Bit-slices w, builds a dynamic scoreboard per k-tile over all S*N
    TransRows of the tile, executes the forest, then shift-accumulates
    per-plane psums with 2's-complement signs.
    """
    w = np.asarray(w)
    x = np.asarray(x)
    n, k = w.shape
    assert x.shape[0] == k and k % t == 0
    rows = bitslice.transrow_matrix(w, bits, t)        # (S, N, K//t)
    signs = bitslice.plane_signs(bits)                 # (S,)
    out = np.zeros((n, x.shape[1]), dtype=np.int64)
    for j in range(k // t):
        tile_rows = rows[:, :, j].reshape(1, -1)       # one tile: S*N rows
        si = dynamic_scoreboard(tile_rows, t, max_distance)
        psum = execute_tile(si, 0, x[j * t:(j + 1) * t])
        vals = rows[:, :, j]                           # (S, N)
        out += (signs[:, None, None] * psum[vals]).sum(0)
    return out
