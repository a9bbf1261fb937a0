"""Fig. 11 (TA energy breakdown on LLaMA-1-7B FC) + Table 2 (core areas)
(port of ``benchmarks/bench_energy_area.py``; modelled accelerators)."""
from __future__ import annotations

import time

from repro_torch.core import energy as E
from repro_torch.core.costmodel import (TransitiveArrayModel, core_area_mm2,
                                        sample_subtile_stats)
from repro_torch.core.workloads import llama_fc_gemms
from repro_torch.paper.common import emit, synth_weights


def run():
    t0 = time.perf_counter()
    prof = sample_subtile_stats(synth_weights(2048, 2048, 4, seed=3), 4,
                                max_tiles=256)
    ta = TransitiveArrayModel(prof, 4).run(llama_fc_gemms("llama1-7b",
                                                          w_bits=4))
    e = ta.energy
    emit("fig11_energy_breakdown", ta.seconds * 1e6,
         f"pe={e.pe/e.total:.3f} buffer={e.buffer/e.total:.3f} "
         f"dram={e.dram/e.total:.3f} static={e.static/e.total:.3f} "
         f"(paper: buffer dominates)")
    areas = core_area_mm2()
    for k, v in areas.items():
        emit(f"table2_area_{k}", 0.0, f"{v:.3f} mm2")
    # Sec. 5.8: a static-SI-only TransArray drops the Scoreboard unit
    saved = E.AREA_TA_SCOREBOARD / 1e6 / areas["transarray"]
    emit("sec58_static_area_saving", 0.0,
         f"{saved:.1%} core area without the dynamic Scoreboard "
         f"(paper: ~25%)")
    emit("fig11_total", (time.perf_counter() - t0) * 1e6, "ok")


if __name__ == "__main__":
    run()
