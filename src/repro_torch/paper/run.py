"""The paper harness's entry point (port of ``benchmarks/run.py``): one section
per paper table or figure, printing ``name,us_per_call,derived`` CSV rows.

  PYTHONPATH=src python -m repro_torch.paper.run [section ...]

With no section named, all six run. The reference's ``kernel`` and
``roofline`` sections are not ported: asked for either, ``main`` exits
non-zero, before running anything, naming the ROADMAP item that brings it.
"""
from __future__ import annotations

import sys
import time

from repro_torch.paper import (bench_attention, bench_dse, bench_energy_area,
                               bench_fc, bench_resnet, bench_scoreboard)

SECTIONS = {
    "dse": bench_dse.run,                # Fig. 9
    "fc": bench_fc.run,                  # Fig. 10
    "energy_area": bench_energy_area.run,  # Fig. 11 + Tbl. 2
    "attention": bench_attention.run,    # Fig. 12
    "scoreboard": bench_scoreboard.run,  # Fig. 13 + Sec. 5.9
    "resnet": bench_resnet.run,          # Fig. 14
}

NOT_PORTED = {
    "kernel": "A4, the port's serve benchmark (bench_kernel's serve "
              "benches)",
    "roofline": "A10, multi-device (launch/roofline.py and "
                "bench_roofline.py: TPU peak tables and XLA HLO)",
}


def main(argv=None) -> None:
    picks = list(sys.argv[1:] if argv is None else argv) or list(SECTIONS)
    for name in picks:
        if name in NOT_PORTED:
            raise SystemExit(f"section '{name}' is not ported yet: ROADMAP "
                             f"item {NOT_PORTED[name]} brings it")
        if name not in SECTIONS:
            raise SystemExit(f"unknown section '{name}'; the sections are "
                             f"{', '.join(SECTIONS)}")
    print("name,us_per_call,derived")
    t0 = time.perf_counter()
    for name in picks:
        SECTIONS[name]()
    print(f"all,{(time.perf_counter()-t0)*1e6:.0f},sections={picks}")


if __name__ == "__main__":
    main()
