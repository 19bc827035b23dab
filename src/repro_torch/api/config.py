"""Unified HURRY configuration — the single derivation point.

The port of ``repro.api.config``.  ``HurryConfig`` holds chip geometry
(tiles, IMAs, array size), crossbar numerics (quantization bit widths,
ADC resolution, read noise) and the JAX package's executor block sizes.
Every downstream structure is *derived* here and nowhere else:

  ``chip()``      -> ``core.simulator.ChipConfig``   (analytical model
                     and scheduler geometry)
  ``crossbar()``  -> ``core.crossbar.CrossbarConfig`` (numeric model +
                     compiled-program executor)
  ``baseline()``  -> ``core.baselines.BaselineConfig`` (ISAAC/MISCA
                     comparison chips sharing this geometry)

Its fields and defaults equal the JAX package's, so one config value
means the same network on both sides, and a saved model's config loads
in either package.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.baselines import BaselineConfig
from repro_torch.core.crossbar import CrossbarConfig
from repro_torch.core.simulator import ChipConfig

# geometry/quantization fields shared verbatim with ChipConfig
_CHIP_FIELDS = ("n_tiles", "imas_per_tile", "array_rows", "array_cols",
                "cell_bits", "weight_bits", "input_bits",
                "bus_bytes_per_cycle", "edram_kb_per_tile", "ir_kb",
                "or_kb", "controller_area_mult")


@dataclasses.dataclass(frozen=True)
class HurryConfig:
    """One config for the whole stack: chip + crossbar + executor."""

    # -- chip geometry (paper §II-A) ---------------------------------------
    n_tiles: int = 16
    imas_per_tile: int = 8
    array_rows: int = 512
    array_cols: int = 512
    cell_bits: int = 1
    bus_bytes_per_cycle: int = 32
    edram_kb_per_tile: int = 512
    ir_kb: int = 32
    or_kb: int = 4
    controller_area_mult: float = 1.12
    sim_batch: int = 16           # pipeline batch of the analytical model

    # -- crossbar numerics (quantization / ADC / read noise) ---------------
    weight_bits: int = 8
    input_bits: int = 8
    adc_bits: int = 9             # paper pairs 512 rows with a 9-bit ADC
    dac_bits: int = 1
    noise_sigma_thermal: float = 0.0
    noise_sigma_shot: float = 0.0

    # -- executor block sizes ----------------------------------------------
    # The JAX package's Pallas block sizes, kept so a config means the
    # same on both sides.  The port's CUDA kernels choose their own tiles
    # and do not read them.
    block_m: int = 512
    block_n: int = 512

    # -- derivations (the only place these conversions exist) --------------

    def chip(self) -> ChipConfig:
        """Chip geometry for the analytical simulator and the scheduler."""
        kw = {f: getattr(self, f) for f in _CHIP_FIELDS}
        return ChipConfig(batch=self.sim_batch, **kw)

    def crossbar(self) -> CrossbarConfig:
        """Numeric array model for the functional path and the executor.

        Delegates to ``ChipConfig.crossbar`` (the base geometry mapping)
        and overlays the knobs only this config carries.
        """
        return self.chip().crossbar(
            adc_bits=self.adc_bits, dac_bits=self.dac_bits,
            noise_sigma_thermal=self.noise_sigma_thermal,
            noise_sigma_shot=self.noise_sigma_shot)

    def baseline(self, **overrides) -> BaselineConfig:
        """ISAAC/MISCA comparison chip sharing this geometry.

        Baseline-specific structure (2-bit MLC cells, halved OR, static
        arrays) keeps ``BaselineConfig`` defaults unless overridden.
        """
        kw = {f: getattr(self, f) for f in _CHIP_FIELDS
              if f not in ("cell_bits", "or_kb", "controller_area_mult")}
        kw.update(batch=self.sim_batch, **overrides)
        return BaselineConfig(**kw)

    @classmethod
    def from_chip(cls, chip: ChipConfig, **overrides) -> "HurryConfig":
        """Lift a bare ChipConfig into the unified config (compat path)."""
        kw = {f: getattr(chip, f) for f in _CHIP_FIELDS}
        kw.update(sim_batch=chip.batch, **overrides)
        return cls(**kw)

    @property
    def clip_free(self) -> bool:
        """DESIGN.md §4 predicate for the derived crossbar numerics."""
        return self.crossbar().clip_free
