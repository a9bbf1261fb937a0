"""Fig. 9 — design space exploration on a 1024x1024 random 0-1 matrix:
(a) density vs TransRow width T; (b) ZR/TR/FR/PR pattern shares;
(c) density vs tile row number N at T=8; (d) node distance statistics
(port of ``benchmarks/bench_dse.py``).
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core.patterns import tile_stats
from repro_torch.core.scoreboard import dynamic_scoreboard
from repro_torch.paper.common import emit


def _binary_matrix(seed=0, size=1024):
    return (np.random.default_rng(seed).random((size, size)) < 0.5)


def run():
    mat = _binary_matrix()
    t0 = time.perf_counter()

    # (a)+(b): vary T at tile row size 256
    for t in (2, 4, 8, 10):
        rows_per_tile = 256
        cols = (1024 // t) * t
        packed = np.packbits(mat[:, :cols].reshape(1024, cols // t, t),
                             axis=-1, bitorder="little")
        vals = packed[..., 0].astype(np.uint32) if t <= 8 else (
            packed[..., 0].astype(np.uint32)
            | (packed[..., 1].astype(np.uint32) << 8))
        flat = vals.T.reshape(-1)
        tiles = flat[: (len(flat) // rows_per_tile) * rows_per_tile]
        tiles = tiles.reshape(-1, rows_per_tile)[:64]
        st = tile_stats(dynamic_scoreboard(tiles, t))
        nz = st.pr + st.fr
        tot = np.maximum(nz + st.zr, 1)
        emit(f"fig9a_density_T{t}", 0.0,
             f"density={st.density.mean():.4f} bound={1.0/t:.4f}")
        emit(f"fig9b_patterns_T{t}", 0.0,
             f"zr={st.zr.mean():.1f} pr={st.pr.mean():.1f} "
             f"fr={st.fr.mean():.1f} tr={st.tr.mean():.1f}")

    # (c)+(d): vary N at T=8
    t = 8
    packed = np.packbits(mat.reshape(1024, 128, 8), axis=-1,
                         bitorder="little")[..., 0].astype(np.uint32)
    flat = packed.T.reshape(-1)
    for n in (16, 32, 64, 128, 256, 512, 1024):
        tiles = flat[: (len(flat) // n) * n].reshape(-1, n)
        tiles = tiles[:max(2, 16384 // n)]
        st = tile_stats(dynamic_scoreboard(tiles, t))
        dist = st.dist_hist.mean(0)
        emit(f"fig9c_density_N{n}", 0.0,
             f"density={st.density.mean():.4f}")
        emit(f"fig9d_dist_N{n}", 0.0,
             f"d1={dist[1]:.1f} d2={dist[2]:.2f} d3={dist[3]:.3f} "
             f"d4+={dist[4]:.3f}")
    emit("fig9_total", (time.perf_counter() - t0) * 1e6, "ok")


if __name__ == "__main__":
    run()
