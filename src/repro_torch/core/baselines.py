"""Baseline architecture models: ISAAC (+size-adjusted variants) and MISCA.

Both baselines (paper §IV-A3) use *static* ReRAM arrays with 2-bit cells
that perform only GEMM; ReLU / max-pool / residual / softmax run in
digital tile units, with every intermediate making an eDRAM round trip —
that data movement is the temporal-utilization killer (up to 48% of
ISAAC's runtime, §I).  Static arrays also cannot overlap reconfiguration
writes with reads, and their 2-bit (MLC) cells need program-and-verify
writes (4x slower, 4x the energy per cell).

  ISAAC(s)  : every IMA holds (512/s)^2 arrays of size s x s (same total
              cell budget per IMA as HURRY); "ISAAC" proper is s = 128.
  MISCA     : three static sizes {128, 256, 512} per IMA (1/3 cell budget
              each); each layer picks the best-fit size (overlapped
              mapping -> high spatial utilization *for the chosen pool*),
              while the other pools idle (the paper's critique, §IV-B3).

Evaluated under the same Energy/Area constants and the same execution
engine as HURRY; only structural parameters differ.

A copy of ``repro.core.baselines``: the port imports nothing of the JAX
package, and this module is pure Python.
"""

from __future__ import annotations

import dataclasses
import math

from .area import AreaLedger, AreaModel
from .energy import EnergyLedger, EnergyModel, adc_bits_for
from .execution import ExecConfig, LayerExec, run_layers
from .simulator import ChipConfig, SimReport
from .workload import LayerSpec, layer_groups


@dataclasses.dataclass(frozen=True)
class BaselineConfig(ChipConfig):
    cell_bits: int = 2            # baselines use 2-bit cells (§IV-A3)
    unit_array: int = 128         # ISAAC proper
    digital_ops_per_tile: int = 128
    or_kb: int = 2                # ISAAC OR (HURRY doubles it)
    controller_area_mult: float = 1.02
    mlc_write_factor: int = 4     # program-and-verify for 2-bit cells

    @property
    def arrays_per_ima(self) -> int:
        # same total cell budget per IMA as HURRY; at least one array
        # even when the unit does not tile the IMA (e.g. 512-unit arrays
        # on a 511-row clip-free geometry)
        return max(1, self.array_rows // self.unit_array) ** 2

    @property
    def n_unit_arrays(self) -> int:
        return self.n_arrays * self.arrays_per_ima


def _gemm_layer_model(head: LayerSpec, s: int, planes: int, phases: int):
    """(n_arrays, mapped_cells, alloc_cells, gemm_cycles, samples, drives)."""
    K = max(head.gemm_rows, 1)
    N = max(head.gemm_cols_logical * planes, 1)
    ar, ac = math.ceil(K / s), math.ceil(N / s)
    n_arrays = ar * ac
    mapped = K * N
    alloc = n_arrays * s * s
    n_vec = max(head.n_vectors, 1)
    gemm_cycles = n_vec * phases          # arrays in lockstep
    samples = n_vec * phases * N * ar     # each row-chunk digitized, then SnA
    drives = n_vec * phases * K * ac
    return n_arrays, mapped, alloc, gemm_cycles, samples, drives


def _digital_and_movement(group: list[LayerSpec], head: LayerSpec):
    """Digital-unit ops and eDRAM round-trip bytes for non-GEMM layers."""
    dig_ops = 0
    move_bytes = 0
    for l in group[1:]:
        if l.kind in ("relu", "residual"):
            dig_ops += l.n_elements
        elif l.kind in ("maxpool", "avgpool"):
            dig_ops += l.n_elements * (l.ksize * l.ksize - 1)
        elif l.kind == "softmax":
            dig_ops += 4 * l.n_elements
        move_bytes += 2 * l.out_bytes                # out + back in
    return dig_ops, move_bytes


def _run_baseline(name: str, layers: list[LayerSpec], chip: BaselineConfig,
                  pick_size, pool_arrays: dict[int, int],
                  controller_mult: float) -> SimReport:
    """Common ISAAC/MISCA path; ``pick_size(head)`` chooses the unit array."""
    em, am = EnergyModel(), AreaModel()
    planes = -(-chip.weight_bits // chip.cell_bits)
    phases = chip.input_phases

    execs: list[LayerExec] = []
    dig_total = 0.0
    dacs = 0.0
    snas = 0.0
    move_total = 0.0
    prev_out_bytes = 3 * 32 * 32
    group_out: dict[str, float] = {}   # group-final layer -> out_bytes
    for group in layer_groups(layers):
        head = group[0]
        # graph-aware input traffic (ResNet shortcut wiring), as in
        # simulate_hurry — both architectures stream the true producer
        in_bytes = (group_out.get(head.input_from, prev_out_bytes)
                    if head.input_from else prev_out_bytes)
        s = pick_size(head)
        adc_bits = adc_bits_for(s, chip.cell_bits)
        n_arr, mapped, alloc, gemm_cyc, samples, drives = _gemm_layer_model(
            head, s, planes, phases)
        dig_ops, move_bytes = _digital_and_movement(group, head)
        weight_cells = (max(head.gemm_rows, 1)
                        * max(head.gemm_cols_logical, 1) * planes)
        n_slots = pool_arrays[s]
        out_bytes = group[-1].out_bytes

        execs.append(LayerExec(
            name=head.name,
            compute_cycles=gemm_cyc,
            write_cells=weight_cells,
            write_cycles=s,                       # columns per static array
            write_overlapped=False,               # cannot read while writing
            dig_ops=dig_ops, move_bytes=move_bytes,
            in_bytes=in_bytes, out_bytes=out_bytes,
            arrays_per_replica=max(1, math.ceil(n_arr * s * s
                                                / (chip.array_rows
                                                   * chip.array_cols))),
            max_replicas=max(1, head.n_vectors),
            mapped_cells=mapped, alloc_cells=alloc,
            active_cell_cycles=mapped * gemm_cyc,
            adc_bits=adc_bits,
            adc_active_cycles=gemm_cyc * n_arr))
        dig_total += dig_ops
        dacs += drives
        snas += samples
        move_total += move_bytes
        group_out[group[-1].name] = out_bytes
        prev_out_bytes = out_bytes

    ecfg = ExecConfig(n_slots=chip.n_arrays,
                      slot_cells=chip.array_rows * chip.array_cols,
                      n_adc_arrays=sum(pool_arrays.values()),
                      bus_bytes_per_cycle=chip.bus_bytes_per_cycle * chip.n_tiles,
                      digital_ops_per_cycle=chip.digital_ops_per_tile
                      * chip.n_tiles,
                      batch=chip.batch,
                      mlc_write_factor=chip.mlc_write_factor)
    res = run_layers(execs, ecfg)

    e = EnergyLedger()
    for bits, act, idle in res.adc_terms:
        e.adc += em.adc_energy_pj(bits, act, idle)
    e.dac = dacs * em.dac_pj
    e.sna = snas * em.sna_pj
    e.alu = dig_total * em.alu_pj
    # MLC writes: program-and-verify costs factor x energy too
    e.cell_write = res.write_cells_total * em.cell_write_pj \
        * chip.mlc_write_factor
    e.cell_read = sum(L.active_cell_cycles for L in execs) \
        * em.cell_read_fj * 1e-3
    io_bytes = sum(L.in_bytes + L.out_bytes for L in execs)
    weight_bytes = sum(L.write_cells for L in execs) / 8 / chip.batch
    e.edram = (io_bytes + move_total + weight_bytes) * em.edram_pj_byte
    e.bus = (io_bytes + move_total + weight_bytes) * em.bus_pj_byte

    a = AreaLedger(controller_mult=controller_mult)
    for s, count in pool_arrays_area(pool_arrays, chip).items():
        bits = adc_bits_for(s, chip.cell_bits)
        a.array += count * am.array_mm2(s, s)
        a.adc += count * am.adc_mm2(bits)
        a.dac += count * s * am.dac_mm2_per_lane
        a.sna_snh += count * s * (am.sna_mm2_per_lane + am.snh_mm2_per_lane)
    a.sram = chip.n_arrays * (chip.ir_kb + chip.or_kb) / 1024 \
        * am.sram_mm2_per_mb
    a.edram = chip.n_tiles * (chip.edram_kb_per_tile / 64) \
        * am.edram_mm2_per_64kb
    a.alu = chip.n_tiles * am.alu_block_mm2

    sp = res.spatial_per_layer
    mean_sp = sum(sp) / len(sp)
    std_sp = (sum((x - mean_sp) ** 2 for x in sp) / len(sp)) ** 0.5
    chip_cells = sum(s * s * c for s, c in
                     pool_arrays_area(pool_arrays, chip).items())
    temporal = res.active_cell_cycles / (chip_cells * res.makespan_cycles)

    return SimReport(name=name, latency_cycles=res.makespan_cycles,
                     throughput_cycles=res.makespan_cycles, energy=e, area=a,
                     spatial_utilization=mean_sp,
                     spatial_utilization_std=std_sp,
                     temporal_utilization=min(temporal, 1.0), exec_result=res)


def pool_arrays_area(pool_arrays: dict[int, int],
                     chip: BaselineConfig) -> dict[int, int]:
    """Chip-wide unit-array counts per size (for the area/cells ledger)."""
    return pool_arrays


def as_baseline(chip) -> BaselineConfig:
    """Accept a BaselineConfig, ``None``, or anything with a
    ``.baseline()`` derivation (``repro_torch.api.HurryConfig``) — the
    unified config derives the comparison chip in one place."""
    if chip is None:
        return BaselineConfig()
    derive = getattr(chip, "baseline", None)
    return derive() if callable(derive) else chip


def simulate_isaac(layers: list[LayerSpec], unit_array: int = 128,
                   chip: BaselineConfig | None = None,
                   name: str | None = None) -> SimReport:
    chip = as_baseline(chip)
    chip = dataclasses.replace(chip, unit_array=unit_array)
    name = name or f"isaac-{unit_array}"
    pools = {unit_array: chip.n_unit_arrays}
    return _run_baseline(name, layers, chip, lambda head: unit_array, pools,
                         chip.controller_area_mult)


def simulate_misca(layers: list[LayerSpec], chip: BaselineConfig | None = None,
                   name: str = "misca") -> SimReport:
    """MISCA: per-layer best-fit among {128,256,512}; other pools idle.

    Overlapped mapping lifts spatial utilization *within the chosen pool*;
    the idle pools are charged in the temporal-utilization denominator and
    in the idle ADC power (the paper's critique, §IV-B3).
    """
    chip = as_baseline(chip)
    sizes = (128, 256, 512)
    per_ima_cells = chip.array_rows * chip.array_cols
    pools = {s: max(1, per_ima_cells // 3 // (s * s)) * chip.n_arrays
             for s in sizes}
    planes = -(-chip.weight_bits // chip.cell_bits)

    def pick(head: LayerSpec) -> int:
        return max(sizes, key=lambda s: (head.gemm_rows
                                         * head.gemm_cols_logical * planes)
                   / _gemm_layer_model(head, s, planes, chip.input_phases)[2])

    return _run_baseline(name, layers, chip, pick, pools, 1.06)
