"""Fig. 12 — Attention-layer speedups over BitFusion (seq 2048).

K/V caches act as dynamically-generated weights — only TA's dynamic
scoreboard (and ANT/BitFusion) support them; TA/ANT run 8-bit group-wise,
BitFusion 16-bit (Sec. 5.7). Port of ``benchmarks/bench_attention.py``;
modelled accelerators.
"""
from __future__ import annotations

import time

from repro_torch.core.costmodel import (AntModel, BitFusionModel, Gemm,
                                        TransitiveArrayModel,
                                        sample_subtile_stats)
from repro_torch.core.workloads import llama_attention_gemms
from repro_torch.paper.common import emit, synth_weights


def run():
    t0 = time.perf_counter()
    prof8 = sample_subtile_stats(synth_weights(2048, 2048, 8, seed=7), 8,
                                 max_tiles=256)
    for name in ("llama1-7b", "llama2-7b", "llama3-8b"):
        att8 = llama_attention_gemms(name, bits=8)
        att16 = [Gemm(g.n, g.k, g.m, 16, 16, g.name) for g in att8]
        ta = TransitiveArrayModel(prof8, 8).run(att8)
        ant = AntModel().run(att8)
        bf = BitFusionModel().run(att16)
        emit(f"fig12_attn_{name}", ta.seconds * 1e6,
             f"vs_bitfusion:x{ta.speedup_over(bf):.2f} "
             f"vs_ant:x{ta.speedup_over(ant):.2f} "
             f"(paper: 3.97x / 1.54x)")
    emit("fig12_total", (time.perf_counter() - t0) * 1e6, "ok")


if __name__ == "__main__":
    run()
