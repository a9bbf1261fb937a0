"""Computation-pattern classification and density statistics (Sec. 5.2,
Fig. 9); port of ``repro.core.patterns``, numpy as there.

Four patterns per TransRow / node:
  ZR — Zero Row:          value 0, skipped entirely.
  FR — Full Result Reuse: a later duplicate of an already-computed node
                          (no PPE, one APE accumulation).
  PR — Prefix Result Reuse: first TransRow of a present node
                          (one PPE add from its prefix + one APE accumulation).
  TR — Transitive Reuse:  a bridge node materialised by the backward pass
                          (one PPE add, no APE — it only relays).

Runtime density (what Fig. 9 plots and what bounds at 1/T) is
``max(PPE_ops, APE_ops) / dense_ops`` — the 3-stage pipeline's throughput is
set by its slowest stage, and APE performs exactly one accumulation per
nonzero TransRow, hence the 1/T floor ("at least one accumulation per T-bit
element").
"""
from __future__ import annotations

import dataclasses
import numpy as np

from repro_torch.core import hasse
from repro_torch.core.scoreboard import ScoreboardInfo

__all__ = ["TileStats", "tile_stats"]


@dataclasses.dataclass
class TileStats:
    """Per-tile operation statistics; every field is (tiles,) int64."""
    n_rows: int
    t: int
    zr: np.ndarray            # zero rows
    fr: np.ndarray            # duplicate rows (full reuse)
    pr: np.ndarray            # first rows of present nodes
    tr: np.ndarray            # bridge nodes
    outliers: np.ndarray      # outlier nodes (distance >= 4)
    ppe_ops: np.ndarray       # total prefix-chain adds
    ape_ops: np.ndarray       # total output accumulations (nonzero rows)
    dense_ops: np.ndarray     # n_rows * T
    bit_ops: np.ndarray       # total popcount (bit-sparsity baseline)
    ppe_cycles: np.ndarray    # max per-lane PPE ops (+ outlier tail)
    ape_cycles: np.ndarray    # max per-lane APE ops
    dist_hist: np.ndarray     # (tiles, 5): executed present nodes at distance 0..4+
                              #  (0 bucket unused; kept for alignment with paper)

    @property
    def density(self) -> np.ndarray:
        return np.maximum(self.ppe_ops, self.ape_ops) / self.dense_ops

    @property
    def density_ppe(self) -> np.ndarray:
        return self.ppe_ops / self.dense_ops

    @property
    def bit_density(self) -> np.ndarray:
        return self.bit_ops / self.dense_ops

    @property
    def cycles(self) -> np.ndarray:
        """Pipeline throughput cycles per sub-tile (critical stage)."""
        return np.maximum(self.ppe_cycles, self.ape_cycles)


def tile_stats(si: ScoreboardInfo) -> TileStats:
    """Derive TileStats from (dynamic) ScoreboardInfo."""
    t, size = si.t, 1 << si.t
    levels = hasse.levels(t)
    counts = si.counts.astype(np.int64)
    present = si.present
    executed = si.executed

    zr = counts[:, 0]
    nonzero_rows = si.n_rows - zr
    unique_present = present.sum(-1).astype(np.int64)
    fr = nonzero_rows - unique_present
    tr = si.bridge.sum(-1).astype(np.int64)
    out_nodes = si.outlier.sum(-1).astype(np.int64)
    pr = unique_present - out_nodes

    # Each executed (non-outlier) node costs one add from its relay prefix;
    # outliers are accumulated directly (popcount adds each).
    out_ops = (si.outlier * levels[None, :]).sum(-1).astype(np.int64)
    ppe_ops = executed.sum(-1).astype(np.int64) + out_ops
    ape_ops = nonzero_rows.astype(np.int64)

    # PPE lanes execute prefix trees serially (dependency chains) — max lane.
    # APE accumulations are crossbar-distributed across lanes (Sec. 4.4), so
    # the APE stage runs at ceil(nonzero_rows / T).
    ppe_cycles = si.wl_ppe.max(-1) + (out_ops + t - 1) // t
    ape_cycles = (ape_ops + t - 1) // t

    dist = si.distance
    hist = np.zeros((si.tiles, 5), dtype=np.int64)
    for d in range(1, 4):
        hist[:, d] = (present & (dist == d)).sum(-1)
    hist[:, 4] = (present & (dist >= 4)).sum(-1)

    bit_ops = (counts * levels[None, :]).sum(-1)
    dense = np.full(si.tiles, si.n_rows * t, dtype=np.int64)
    return TileStats(n_rows=si.n_rows, t=t, zr=zr, fr=fr, pr=pr, tr=tr,
                     outliers=out_nodes, ppe_ops=ppe_ops, ape_ops=ape_ops,
                     dense_ops=dense, bit_ops=bit_ops,
                     ppe_cycles=ppe_cycles, ape_cycles=ape_cycles,
                     dist_hist=hist)
