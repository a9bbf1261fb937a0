"""Fig. 14 / Sec. 5.10 — ResNet-18 (im2col GEMMs) speedups: TA with mixed
4/8-bit vs BitFusion and ANT (port of ``benchmarks/bench_resnet.py``;
modelled accelerators)."""
from __future__ import annotations

import time

from repro_torch.core.costmodel import (AntModel, BitFusionModel,
                                        TransitiveArrayModel,
                                        sample_subtile_stats)
from repro_torch.core.workloads import resnet18_gemms
from repro_torch.paper.common import emit, synth_weights


def run():
    t0 = time.perf_counter()
    prof4 = sample_subtile_stats(synth_weights(1024, 1024, 4, seed=5), 4,
                                 max_tiles=128)
    gemms = resnet18_gemms(w_bits=4)
    ta = TransitiveArrayModel(prof4, 4).run(gemms)
    bf = BitFusionModel().run(gemms)
    ant = AntModel().run(gemms)
    emit("fig14_resnet18", ta.seconds * 1e6,
         f"vs_bitfusion:x{ta.speedup_over(bf):.2f} "
         f"vs_ant:x{ta.speedup_over(ant):.2f} (paper: 4.26x / 2.21x)")
    emit("fig14_total", (time.perf_counter() - t0) * 1e6, "ok")


if __name__ == "__main__":
    run()
