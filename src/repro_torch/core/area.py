"""Area model — component areas at 32 nm (§IV-A, §IV-B4).

Anchors (public ISAAC table + standard scaling):
  ADC 8-bit 1.28 GS/s: 0.0012 mm^2, area ~2x per extra bit.
  ReRAM cell: 4F^2 crossbar -> 512x512 array = 262144 * 4*(32nm)^2
              ~= 0.00107 mm^2 (periphery dominates — the paper's point).
  DAC lane (1-bit): 0.00017 mm^2 per 128 lanes.
  SnA 0.00024 mm^2, SnH 0.00004 mm^2 per 128 lanes.
  SRAM: ~0.165 mm^2/MB (IR/OR);  eDRAM: ~0.0834 mm^2 per 64 KB bank.
  Digital ALU block (baseline ReLU/pool units): 0.004 mm^2 per tile.
  LUT block: 0.0006 mm^2 per tile.
HURRY overheads stated by the paper and applied here: OR doubled
(0.0014 mm^2 per unit, 1.96% of IMA area), controller up to 12% of chip
area (multiplier 1.12 on HURRY chips; static baselines use 1.02).

A copy of ``repro.core.area``: the port imports nothing of the JAX
package, and this module is pure Python.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AreaModel:
    adc_base_mm2: float = 0.004   # 8-bit 1.28 GS/s @32nm (Murmann-survey scale)
    adc_base_bits: int = 8
    cell_mm2: float = 4 * (32e-6) ** 2          # 4F^2, F = 32 nm, in mm^2
    dac_mm2_per_lane: float = 0.00017 / 128
    sna_mm2_per_lane: float = 0.00024 / 128
    snh_mm2_per_lane: float = 0.00004 / 128
    sram_mm2_per_mb: float = 0.165
    edram_mm2_per_64kb: float = 0.03   # dense 32nm eDRAM macro
    alu_block_mm2: float = 0.004
    lut_block_mm2: float = 0.0006

    def adc_mm2(self, bits: int) -> float:
        return self.adc_base_mm2 * (2.0 ** (bits - self.adc_base_bits))

    def array_mm2(self, rows: int, cols: int) -> float:
        return rows * cols * self.cell_mm2


@dataclasses.dataclass
class AreaLedger:
    """Accumulates component areas (mm^2) for one chip."""

    array: float = 0.0
    adc: float = 0.0
    dac: float = 0.0
    sna_snh: float = 0.0
    sram: float = 0.0
    edram: float = 0.0
    alu: float = 0.0
    lut: float = 0.0
    controller_mult: float = 1.0

    @property
    def total_mm2(self) -> float:
        base = (self.array + self.adc + self.dac + self.sna_snh
                + self.sram + self.edram + self.alu + self.lut)
        return base * self.controller_mult

    def as_dict(self) -> dict[str, float]:
        d = dataclasses.asdict(self)
        d["total_mm2"] = self.total_mm2
        return d
