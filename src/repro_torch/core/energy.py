"""Energy model — per-operation energies at 32 nm / 100 MHz (§IV-A).

The paper modifies PUMAsim with ISAAC-lineage component models (ReRAM cell
model from Hu et al. DAC'16 [7]); it does not publish a full constant
table, so the constants below are taken from the public ISAAC/PUMA numbers
and standard scaling laws, documented per entry.  All compared
architectures (HURRY, ISAAC-128/256/512, MISCA) are evaluated under the
*same* constants — only structural counts differ (array sizes, ADC
resolution, data-movement bytes, digital-unit ops) — so the relative
claims (Fig 6) are driven by the paper's mechanisms, not constant tuning.

  adc_pj(bits)        Walden-style: E/sample ~ 2^bits.  Anchored at the
                      ISAAC 8-bit 1.28 GS/s ADC (2 mW -> 1.56 pJ/sample).
  dac_pj              1-bit DAC drive, ISAAC DAC-array power / lanes.
  cell_read_fj        ~1 fJ/cell/read at low read voltage (DPE [7]).
  cell_write_pj       ReRAM SET/RESET ~2 pJ/bit (typ. HfOx).
  sna_pj / snh_pj     shift-&-add / sample-&-hold per op (ISAAC table).
  edram_pj_byte       eDRAM access ~2 pJ/B (ISAAC 64 KB banks).
  bus_pj_byte         on-chip movement (router+HTree) ~1 pJ/B.
  alu_pj              digital ReLU/max/add op in baseline units.
  lut_pj              tile LUT lookup (softmax exp/log path).

A copy of ``repro.core.energy``: the port imports nothing of the JAX
package, and this module is pure Python.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    # -- power-based terms (periphery burns power while its array is in
    #    the pipeline; idle periphery is only partially gate-able).  This
    #    is the accounting behind the paper's temporal-utilization ->
    #    energy-efficiency link and behind Fig 1b's "16x 7-bit ADCs use
    #    3.4x the power of one 9-bit ADC" (16*2^7 / 2^9 = 4).
    adc_power_mw: float = 2.0      # 8-bit anchor (ISAAC: 2 mW @ 1.28 GS/s)
    adc_base_bits: int = 8
    idle_frac: float = 0.6         # un-gated fraction of periphery power
    cycle_ns: float = 10.0         # 100 MHz
    # -- per-event dynamic terms
    dac_pj: float = 0.04           # per 1-bit conversion
    cell_read_fj: float = 0.5      # per cell per read cycle (DPE [7] scale)
    cell_write_pj: float = 2.0     # per cell write (SLC SET/RESET)
    sna_pj: float = 0.05           # per shift-add op
    snh_pj: float = 0.001          # per sample-hold
    edram_pj_byte: float = 4.0
    bus_pj_byte: float = 2.0
    alu_pj: float = 0.25           # digital compare/add (baselines)
    lut_pj: float = 0.5            # per LUT lookup

    def adc_cycle_pj(self, bits: int) -> float:
        """ADC energy per active cycle per array (mW * ns = pJ)."""
        return (self.adc_power_mw * (2.0 ** (bits - self.adc_base_bits))
                * self.cycle_ns)

    def adc_energy_pj(self, bits: int, active_cycles: float,
                      idle_cycles: float) -> float:
        return self.adc_cycle_pj(bits) * (active_cycles
                                          + self.idle_frac * idle_cycles)


def adc_bits_for(rows: int, cell_bits: int) -> int:
    """ADC resolution needed to digitize a bitline: count <= rows*(2^c-1).

    Reproduces the paper's pairings: 128 rows/1-bit -> 7-bit ADC (Fig 1b),
    512 rows/1-bit -> 9-bit ADC (§II-A).
    """
    return math.ceil(math.log2(rows)) + (cell_bits - 1)


@dataclasses.dataclass
class EnergyLedger:
    """Accumulates component energies (in pJ) for one inference."""

    adc: float = 0.0
    dac: float = 0.0
    cell_read: float = 0.0
    cell_write: float = 0.0
    sna: float = 0.0
    edram: float = 0.0
    bus: float = 0.0
    alu: float = 0.0
    lut: float = 0.0

    @property
    def total_pj(self) -> float:
        return (self.adc + self.dac + self.cell_read + self.cell_write
                + self.sna + self.edram + self.bus + self.alu + self.lut)

    def as_dict(self) -> dict[str, float]:
        d = dataclasses.asdict(self)
        d["total_pj"] = self.total_pj
        return d
