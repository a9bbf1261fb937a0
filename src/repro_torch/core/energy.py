"""28 nm energy/area constants shared by the TA cost model and baselines
(port of ``repro.core.energy``; the values are the reference's, copied).

These describe the paper's *modelled* accelerators (28 nm ASICs at
500 MHz), not the GPU the port runs on: no number here, and no number
the cost model derives from them, is a measurement of any chip.

Per-op energies follow Horowitz (ISSCC'14, 45 nm) scaled by ~0.7x to 28 nm;
SRAM/DRAM follow CACTI-7-class numbers at 28 nm. Absolute pJ values are
*modeled*; the reproduction target is the paper's speedup/energy
**ratios**. Area constants are taken directly from the paper's Table 2
(they were synthesized with Synopsys DC at 28 nm).
"""
from __future__ import annotations

import dataclasses

# --- per-op dynamic energy (pJ), 28 nm -------------------------------------
PJ_ADD_8 = 0.021       # 8-bit int add
PJ_ADD_12 = 0.032      # 12-bit adder (TA PPE)
PJ_ADD_24 = 0.063      # 24-bit accumulator (TA APE)
PJ_ADD_32 = 0.070      # 32-bit add
PJ_MUL_8 = 0.140       # 8-bit int multiply
PJ_MUL_4 = 0.040       # 4-bit int multiply
PJ_MUL_16 = 0.560      # 16-bit int multiply
PJ_MAC_8 = PJ_MUL_8 + PJ_ADD_32
PJ_MAC_4 = PJ_MUL_4 + PJ_ADD_24
PJ_MAC_16 = PJ_MUL_16 + PJ_ADD_32

# --- memory (pJ per byte) ---------------------------------------------------
PJ_SRAM_BYTE = 0.62    # ~80KB-class on-chip buffer access
PJ_REG_BYTE = 0.08     # small distributed prefix-buffer bank access
PJ_DRAM_BYTE = 120.0   # off-chip DRAM (15 pJ/bit)

# --- static power (mW) ------------------------------------------------------
MW_STATIC_CORE = 45.0      # leak for the ~0.5 mm^2 core + 0.5 MB buffers
MW_STATIC_DRAM = 250.0     # DRAM background/refresh power; Fig. 11 credits
                           # TA's energy win largely to reduced DRAM static
FREQ_HZ = 500e6            # all designs evaluated at 500 MHz (Sec. 5.1)

# --- areas (um^2), straight from the paper's Table 2 ------------------------
AREA_TA_PPE = 50.3
AREA_TA_APE = 101.7
AREA_TA_NOC = 19520.0
AREA_TA_SCOREBOARD = 92507.0
AREA_BITFUSION_PE = 548.0
AREA_ANT_PE = 210.0
AREA_OLIVE_PE = 319.0
AREA_BITVERT_PE = 985.0
AREA_TENDER_PE = 329.0


@dataclasses.dataclass(frozen=True)
class EnergyTally:
    """Accumulated energy in pJ by component (Fig. 11 breakdown)."""
    pe: float = 0.0
    buffer: float = 0.0
    dram: float = 0.0
    static: float = 0.0

    @property
    def total(self) -> float:
        return self.pe + self.buffer + self.dram + self.static

    def __add__(self, o: "EnergyTally") -> "EnergyTally":
        return EnergyTally(self.pe + o.pe, self.buffer + o.buffer,
                           self.dram + o.dram, self.static + o.static)
