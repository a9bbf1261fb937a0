"""Fig. 10 — runtime & energy on the FC layers of LLaMA models, all six
accelerators (port of ``benchmarks/bench_fc.py``). Weights are synthetic
Gaussian-quantized (Sec. 5.9: random vs real differ by only a few
percent); the TA model is driven by the measured dynamic-scoreboard
statistics of those weights. Times and energies are the modelled
accelerators'.
"""
from __future__ import annotations

import time

from repro_torch.core.costmodel import (AntModel, BitFusionModel,
                                        BitVertModel, OliveModel,
                                        TenderModel, TransitiveArrayModel,
                                        sample_subtile_stats)
from repro_torch.core.workloads import llama_fc_gemms
from repro_torch.paper.common import emit, synth_weights

MODELS = ["llama1-7b", "llama1-13b", "llama1-30b", "llama1-65b",
          "llama2-7b", "llama2-13b", "llama3-8b"]


def run(models=None):
    t0 = time.perf_counter()
    prof8 = sample_subtile_stats(synth_weights(2048, 2048, 8), 8,
                                 max_tiles=256)
    prof4 = sample_subtile_stats(synth_weights(2048, 2048, 4), 4,
                                 max_tiles=256)
    baselines = [BitFusionModel(), AntModel(), OliveModel(), BitVertModel()]
    for name in (models or MODELS):
        g8 = llama_fc_gemms(name, w_bits=8)
        g4 = llama_fc_gemms(name, w_bits=4)
        ta8 = TransitiveArrayModel(prof8, 8).run(g8)
        ta4 = TransitiveArrayModel(prof4, 4).run(g4)
        td = TenderModel().run(llama_fc_gemms(name, w_bits=4, a_bits=4))
        parts = []
        for b in baselines:
            r = b.run(g8)
            parts.append(f"{b.name}:x{ta4.speedup_over(r):.2f}/"
                         f"e{r.energy.total / ta4.energy.total:.2f}")
        parts.append(f"tender4:x{ta4.speedup_over(td):.2f}")
        parts.append(f"ta8_vs_olive:x{ta8.speedup_over(OliveModel().run(g8)):.2f}")
        emit(f"fig10_fc_{name}", ta4.seconds * 1e6, " ".join(parts))
    emit("fig10_total", (time.perf_counter() - t0) * 1e6,
         "paper: TA4 vs ANT 4.91x/1.65x, Olive 7.46x/2.31x, BitVert 3.97x/1.65x")


if __name__ == "__main__":
    run()
