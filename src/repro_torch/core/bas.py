"""Block Activation Scheme (BAS) — array-level concurrency model (§II-B).

BAS adapts the third-voltage select scheme: V_set writes, 1/3 V_set / 2/3
V_set bias non-selected cells, letting *disjoint* FBs in one array be
active in the same cycle — e.g. FB1 is written column-by-column while FB2
keeps reading (paper Fig 3).  The consequences modeled here:

* legality — FBs must be disjoint rectangles inside the array;
* concurrency — per pipeline wave, each FB's work (reads, refresh writes,
  max-logic rounds) overlaps; the wave latency is the max over FBs, not
  the sum (this is what lifts temporal utilization);
* accounting — per-cycle active-cell integration yields the paper's
  temporal-utilization metric; mapped-cell counting yields the spatial
  metric.

``ArrayPlan`` is the unit the simulator schedules: one 512x512 array (one
IMA) holding a placed chain of FBs for a slice of the CNN.

A copy of ``repro.core.bas``: the port imports nothing of the JAX
package, and this module is pure Python.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from .functional_blocks import FunctionalBlock


@dataclasses.dataclass(frozen=True)
class ArrayConfig:
    rows: int = 512
    cols: int = 512
    input_phases: int = 8     # bit-serial int8 inputs through 1-bit DACs

    @property
    def cells(self) -> int:
        return self.rows * self.cols


@dataclasses.dataclass
class WaveCost:
    """Per-pipeline-wave cycle cost of one FB (overlappable under BAS)."""

    fb: FunctionalBlock
    read_cycles: float
    write_cycles: float

    @property
    def total(self) -> float:
        return self.read_cycles + self.write_cycles


@dataclasses.dataclass
class ArraySchedule:
    """Resolved schedule of one array: makespan + utilization integrals."""

    plan_name: str
    n_waves: int
    wave_costs: list[WaveCost]
    makespan_cycles: float
    active_cell_cycles: float
    mapped_cells: int
    array_cells: int
    fill_cycles: float = 0.0      # pipeline fill (amortized over a batch)
    steady_cycles: float = 0.0    # per-image steady-state cycles

    @property
    def temporal_utilization(self) -> float:
        if self.makespan_cycles <= 0:
            return 0.0
        return self.active_cell_cycles / (self.array_cells * self.makespan_cycles)

    @property
    def spatial_utilization(self) -> float:
        return self.mapped_cells / self.array_cells


def check_legal(blocks: Sequence[FunctionalBlock], cfg: ArrayConfig) -> None:
    """FBs must be disjoint rectangles inside the array."""
    for b in blocks:
        if b.row0 < 0 or b.col0 < 0:
            raise ValueError(f"FB {b.fb_id} has negative origin")
        if b.row0 + b.rows > cfg.rows or b.col0 + b.cols > cfg.cols:
            raise ValueError(
                f"FB {b.fb_id} ({b.rows}x{b.cols} @ {b.row0},{b.col0}) "
                f"exceeds the {cfg.rows}x{cfg.cols} array")
    for i, a in enumerate(blocks):
        for b in blocks[i + 1:]:
            if (a.row0 < b.row0 + b.rows and b.row0 < a.row0 + a.rows and
                    a.col0 < b.col0 + b.cols and b.col0 < a.col0 + a.cols):
                raise ValueError(f"FBs {a.fb_id} and {b.fb_id} overlap")


def schedule_array(blocks: Sequence[FunctionalBlock], cfg: ArrayConfig,
                   name: str = "array", pipelined: bool = True) -> ArraySchedule:
    """Compute the fine-grained pipeline makespan of an FB chain (§III-A).

    The head GEMM FB defines the wave count: with parallelism P (kernel
    copies that fit its allocation) it needs ceil(n_vectors / P) read
    passes.  Every other FB's total work is amortized per wave; under BAS
    (pipelined=True) the wave latency is the max FB cost, without BAS it
    is the sum (serialized array use).
    """
    check_legal(blocks, cfg)
    gemm = [b for b in blocks if b.kind in ("conv", "fc")]
    head = gemm[0] if gemm else blocks[0]
    req = head.request
    # only column-copies run concurrently (row-copies share bitlines)
    par = head.col_parallelism()
    n_waves = max(1, math.ceil(req.n_vectors / par))

    costs: list[WaveCost] = []
    for b in blocks:
        total_read = b.compute_cycles(cfg.input_phases)
        read_per_wave = total_read / n_waves
        if b.kind in ("conv", "fc"):
            # weight-stationary: the mount write is handled at chip level
            # (batch-amortized + BAS-overlapped), not per wave
            write_per_wave = 0.0
        elif b.kind == "res":
            # refresh one column per freshly produced output vector
            write_per_wave = min(b.cols, par)
        else:
            # input-stationary: producer outputs written in each wave
            write_per_wave = min(b.cols, par)
        costs.append(WaveCost(b, read_per_wave, write_per_wave))

    if pipelined:
        wave_latency = max(c.total for c in costs)
        fill = (len(costs) - 1) * wave_latency
        steady = n_waves * wave_latency
    else:
        wave_latency = sum(c.total for c in costs)
        fill = 0.0
        steady = n_waves * wave_latency
    makespan = fill + steady

    # only mapped cells are *activated* (third-voltage biasing keeps the
    # rest at <= 1/3 V_set: negligible current, not counted active)
    active = sum(n_waves * c.total * c.fb.mapped_cells for c in costs)
    mapped = sum(b.mapped_cells for b in blocks)
    return ArraySchedule(
        plan_name=name, n_waves=n_waves, wave_costs=costs,
        makespan_cycles=makespan, active_cell_cycles=active,
        mapped_cells=mapped, array_cells=cfg.cells,
        fill_cycles=fill, steady_cycles=steady)
