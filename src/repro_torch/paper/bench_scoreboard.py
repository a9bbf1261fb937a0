"""Fig. 13 + Sec. 5.9 — static vs dynamic Scoreboard on real-like and
random data across tile row sizes, and the unique-TransRow statistic
(port of ``benchmarks/bench_scoreboard.py``).
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core import bitslice
from repro_torch.core.patterns import tile_stats
from repro_torch.core.scoreboard import (dynamic_scoreboard,
                                         static_scoreboard,
                                         static_tile_stats)
from repro_torch.paper.common import emit, synth_weights


def _transrows(w, bits, t=8):
    rows = bitslice.transrow_matrix(w, bits, t)       # (S, N, K/t)
    return rows.transpose(2, 1, 0).reshape(-1)


def run():
    t0 = time.perf_counter()
    real = _transrows(synth_weights(1024, 1024, 8, seed=1), 8)
    rand = np.random.default_rng(2).integers(
        0, 256, size=len(real)).astype(np.uint32)

    for label, rows in (("real", real), ("rand", rand)):
        ssi = static_scoreboard(rows, 8)
        uniq = []
        for n in (64, 128, 256, 512, 1024):
            tiles = rows[: (len(rows) // n) * n].reshape(-1, n)
            tiles = tiles[:max(4, 8192 // n)]
            dyn = tile_stats(dynamic_scoreboard(tiles, 8))
            stt = static_tile_stats(ssi, tiles)
            d_dyn = dyn.density.mean()
            d_stat = float(np.mean(np.maximum(stt["ppe"], stt["ape"])
                                   / stt["dense"]))
            emit(f"fig13_{label}_N{n}", 0.0,
                 f"dynamic={d_dyn:.4f} static={d_stat:.4f}")
            if n == 256:
                si = dynamic_scoreboard(tiles, 8)
                uniq.append(si.present.sum(-1).mean())
        emit(f"sec59_unique_{label}", 0.0,
             f"mean_unique_of_256={uniq[0]:.1f} (paper: ~162, real slightly "
             f"lower)")
    emit("fig13_total", (time.perf_counter() - t0) * 1e6, "ok")


if __name__ == "__main__":
    run()
