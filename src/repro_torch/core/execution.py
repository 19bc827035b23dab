"""Shared chip execution model — layer-streaming with per-layer replication.

Execution semantics (one 16-tile chip, paper §II-A):

* The network runs layer-group by layer-group; for each group, the chip's
  array slots are partitioned into as many lock-step *replicas* of the
  group's array set as fit (bounded by the number of GEMM vectors that can
  be split across replicas).
* Weights are (re)written per layer visit — this is what "reconfigurable"
  buys at system level:
    - HURRY: BAS overlaps writing the next group's FBs with the current
      group's reads (paper Fig 3) -> the write cost is hidden unless it
      exceeds the compute time.  SLC (1-bit) writes, one pass.
    - baselines: static arrays cannot read while being written -> the
      write serializes; MLC (2-bit) cells need program-and-verify
      (``mlc_write_factor`` slower and more energy per cell).
* Inputs/outputs stream over the shared chip bus (16 tiles x 32 B);
  baselines additionally round-trip every intermediate (ReLU / pool /
  res / softmax) through eDRAM + digital units — the data movement the
  paper measures at up to 48% of ISAAC runtime.
* A ``batch`` of inputs is processed per configuration pass, amortizing
  weight writes (both architectures equally).

Temporal utilization = active-cell integral / (chip cells x makespan).
Spatial utilization = mapped / allocated cells, averaged per layer.
ADC energy feeds off (active, idle) cycle pairs per layer (power x time).

A copy of ``repro.core.execution``: the port imports nothing of the JAX
package, and this module is pure Python.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class LayerExec:
    """Per-layer-group execution record produced by an architecture model."""

    name: str
    compute_cycles: float        # in-array compute, single-replica basis
    write_cells: float           # weight cells (re)written per config pass
    write_cycles: float          # write time for one replica's arrays
    write_overlapped: bool       # BAS hides it under compute
    dig_ops: float = 0.0         # digital-unit ops (baselines)
    move_bytes: float = 0.0      # eDRAM round-trips beyond in/out streaming
    in_bytes: float = 0.0
    out_bytes: float = 0.0
    arrays_per_replica: int = 1
    max_replicas: int = 1 << 30  # bounded by splittable vectors
    mapped_cells: float = 0.0    # per replica
    alloc_cells: float = 0.0     # per replica (FB bounding boxes)
    active_cell_cycles: float = 0.0   # whole-group total (replica-invariant)
    adc_bits: int = 9
    adc_active_cycles: float = 0.0    # whole-group ADC-array-active cycles
    lut_ops: float = 0.0


@dataclasses.dataclass
class ExecConfig:
    n_slots: int                 # replica array slots (HURRY: 128)
    slot_cells: int              # cells per slot
    n_adc_arrays: int            # ADC-bearing unit arrays chip-wide
    bus_bytes_per_cycle: int = 512      # 16 tiles x 32 B
    digital_ops_per_cycle: int = 2048   # 16 tiles x 128-lane ALU (baselines)
    batch: int = 16              # images per configuration pass
    mlc_write_factor: int = 1    # program-verify slowdown (2-bit cells: 4)


@dataclasses.dataclass
class ExecResult:
    makespan_cycles: float       # per-inference steady-state cycles
    replicas: list[int]
    layer_cycles: list[float]
    stall_cycles: float
    active_cell_cycles: float
    spatial_per_layer: list[float]
    write_cells_total: float     # per inference (batch-amortized)
    adc_terms: list[tuple[int, float, float]]   # (bits, active, idle)


def run_layers(layers: list[LayerExec], cfg: ExecConfig) -> ExecResult:
    makespan = 0.0
    stall = 0.0
    active = 0.0
    spatial = []
    write_cells = 0.0
    replicas_out = []
    times = []

    for L in layers:
        # mount factor: a layer wider than the chip is processed in
        # sequential mounting rounds (weights rewritten per round)
        mount = max(1, -(-L.arrays_per_replica // cfg.n_slots))
        if mount == 1:
            reps = max(1, min(cfg.n_slots // max(L.arrays_per_replica, 1),
                              L.max_replicas))
        else:
            reps = 1
        replicas_out.append(reps)
        compute = L.compute_cycles * mount / reps
        stream = (L.in_bytes + L.out_bytes) / cfg.bus_bytes_per_cycle
        dig = L.dig_ops / cfg.digital_ops_per_cycle
        move = L.move_bytes / cfg.bus_bytes_per_cycle
        write = L.write_cycles * mount * cfg.mlc_write_factor / cfg.batch
        if L.write_overlapped:
            # BAS (Fig 3): write + input streaming hide under compute
            t = max(compute, write, stream) + dig + move
        else:
            # static arrays: write, then compute, then move/digital
            t = write + compute + stream + dig + move
        stall += t - compute
        times.append(t)
        makespan += t
        active += L.active_cell_cycles
        spatial.append(L.mapped_cells / max(L.alloc_cells, 1.0))
        write_cells += L.write_cells / cfg.batch

    adc_terms = []
    for L, t in zip(layers, times):
        act = L.adc_active_cycles
        idle = cfg.n_adc_arrays * t - act
        adc_terms.append((L.adc_bits, act, max(idle, 0.0)))

    return ExecResult(makespan_cycles=makespan, replicas=replicas_out,
                      layer_cycles=times, stall_cycles=stall,
                      active_cell_cycles=active, spatial_per_layer=spatial,
                      write_cells_total=write_cells, adc_terms=adc_terms)
