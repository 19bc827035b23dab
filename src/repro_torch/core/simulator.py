"""End-to-end HURRY chip simulator (paper §II-§IV).

Chip structure (paper §II-A): 16 tiles x 8 IMAs; each HURRY IMA has one
512x512 1-bit-cell array with a 9-bit ADC, 1-bit DACs, 32KB IR / 4KB OR
(OR doubled vs ISAAC, §IV-B4), SnH/SnA; each tile has 512KB eDRAM and a
LUT block (softmax exp/log).

Scheduling flow per GEMM layer group (conv|fc + trailing res/relu/pool):
  1. build FBRequests (HMS: conv weight-stationary, others input-stationary)
  2. Algorithm 2 sizes FBs inside one 512x512 array
  3. Algorithm 1 + sequence-pair decode places them
  4. the BAS model pipelines the FB chain -> per-group compute cycles and
     active-cell integral
  5. the shared execution engine streams the network through the chip,
     replicating each group across the 128 arrays, with next-group weight
     writes overlapped under current-group reads (BAS, Fig 3).

Reported metrics mirror the paper's: latency/throughput (Fig 7), energy &
area (Fig 6), spatial & temporal utilization (Fig 8).

A copy of ``repro.core.simulator``: the port imports nothing of the JAX
package, and this module is pure Python.
"""

from __future__ import annotations

import dataclasses
import math

from .area import AreaLedger, AreaModel
from .bas import ArrayConfig, schedule_array
from .energy import EnergyLedger, EnergyModel, adc_bits_for
from .execution import ExecConfig, ExecResult, LayerExec, run_layers
from .functional_blocks import FBRequest, tournament_rounds
from .scheduling import plan_array
from .workload import LayerSpec, layer_groups


@dataclasses.dataclass(frozen=True)
class ChipConfig:
    n_tiles: int = 16
    imas_per_tile: int = 8
    array_rows: int = 512
    array_cols: int = 512
    cell_bits: int = 1
    weight_bits: int = 8
    input_bits: int = 8
    bus_bytes_per_cycle: int = 32        # per tile
    edram_kb_per_tile: int = 512
    ir_kb: int = 32
    or_kb: int = 4              # doubled vs ISAAC's 2KB (§IV-B4)
    controller_area_mult: float = 1.12   # up to 12% of chip area (§IV-B4)
    batch: int = 16

    def crossbar(self, **overrides) -> "CrossbarConfig":
        """Numeric array model matching this chip's geometry/bit widths.

        The base ChipConfig -> CrossbarConfig derivation; knobs that are
        not chip structure (ADC/DAC resolution, read noise) keep their
        ``CrossbarConfig`` defaults unless overridden.  The unified
        ``repro_torch.api.HurryConfig`` derives through here too, so this
        mapping exists exactly once.
        """
        from .crossbar import CrossbarConfig
        kw = dict(rows=self.array_rows, cols=self.array_cols,
                  cell_bits=self.cell_bits, weight_bits=self.weight_bits,
                  input_bits=self.input_bits)
        kw.update(overrides)
        return CrossbarConfig(**kw)

    @property
    def n_arrays(self) -> int:
        return self.n_tiles * self.imas_per_tile

    @property
    def weight_planes(self) -> int:
        return -(-self.weight_bits // self.cell_bits)

    @property
    def input_phases(self) -> int:
        return self.input_bits  # 1-bit DACs


@dataclasses.dataclass
class SimReport:
    name: str
    latency_cycles: float
    throughput_cycles: float
    energy: EnergyLedger
    area: AreaLedger
    spatial_utilization: float
    spatial_utilization_std: float
    temporal_utilization: float
    exec_result: ExecResult

    @property
    def energy_pj(self) -> float:
        return self.energy.total_pj

    @property
    def area_mm2(self) -> float:
        return self.area.total_mm2

    @property
    def energy_efficiency(self) -> float:
        """Inferences per joule (x1e6 = inferences/uJ scale)."""
        return 1e12 / self.energy_pj

    @property
    def area_efficiency(self) -> float:
        """Inferences/s/mm^2 at 100 MHz."""
        return 1e8 / self.throughput_cycles / self.area_mm2

    def summary(self) -> dict[str, float]:
        return {
            "throughput_cycles": self.throughput_cycles,
            "energy_uj": self.energy_pj / 1e6,
            "area_mm2": self.area_mm2,
            "spatial_util": self.spatial_utilization,
            "temporal_util": self.temporal_utilization,
        }


# ---------------------------------------------------------------------------
# FB request construction (HMS, §III-C)
# ---------------------------------------------------------------------------

_RES_ROWS = 8         # residual input bit rows merged under the conv FB


def _maxlogic_rows(window: int, bits: int) -> int:
    """Tree tournament storage: operands + one intermediate row per round."""
    return bits * (tournament_rounds(window) + 1) + 2


def build_group_requests(group: list[LayerSpec], chip: ChipConfig
                         ) -> tuple[list[FBRequest], dict[int, int], LayerSpec]:
    """FB requests + consumer edges for one GEMM layer group.

    The GEMM request is the *per-array slice*: consumer FBs reserve their
    rows below the GEMM FB first, then the GEMM slice takes what remains;
    the layer's full extent is covered by lock-step arrays (n_arrays in
    the simulator), so mount_rounds stays 1 by construction.
    """
    head = group[0]
    planes = chip.weight_planes

    has_relu = any(l.kind == "relu" for l in group[1:])
    pool = next((l for l in group[1:] if l.kind == "maxpool"), None)
    res = next((l for l in group[1:] if l.kind == "residual"), None)
    smax = next((l for l in group[1:] if l.kind == "softmax"), None)

    consumer_rows = 0
    if res is not None:
        consumer_rows += _RES_ROWS
    if pool is not None:
        consumer_rows += _maxlogic_rows(pool.ksize * pool.ksize,
                                        chip.input_bits)
    elif has_relu:
        consumer_rows += _maxlogic_rows(2, chip.input_bits)
    if smax is not None:
        consumer_rows += _maxlogic_rows(max(smax.n_elements, 2), 16)

    slice_rows = max(1, min(head.gemm_rows,
                            chip.array_rows - consumer_rows))
    slice_cols = max(1, min(head.gemm_cols_logical * planes, chip.array_cols))
    reqs = [FBRequest(kind="conv" if head.kind == "conv" else "fc",
                      layer=head.name, req_rows=slice_rows,
                      req_cols=slice_cols, n_vectors=max(head.n_vectors, 1),
                      data_bits=chip.input_bits)]
    consumes: dict[int, int] = {}
    # fraction of the layer's logical outputs produced by this array slice
    slice_frac = slice_cols / max(head.gemm_cols_logical * planes, 1)

    if res is not None:
        reqs.append(FBRequest(kind="res", layer=res.name, req_rows=_RES_ROWS,
                              req_cols=slice_cols, data_bits=chip.input_bits))
        consumes[len(reqs) - 1] = 0
    if pool is not None:
        # merged max(+relu) FB (§II-C2); windows tiled across columns
        window = pool.ksize * pool.ksize
        n_win = max(1, int(pool.n_elements * slice_frac))
        reqs.append(FBRequest(kind="max", layer=pool.name,
                              req_rows=_maxlogic_rows(window, chip.input_bits),
                              req_cols=min(window * n_win, chip.array_cols),
                              n_vectors=n_win, window=window,
                              data_bits=chip.input_bits))
        consumes[len(reqs) - 1] = len(reqs) - 2 if res is not None else 0
    elif has_relu:
        n_el = next(l for l in group[1:] if l.kind == "relu").n_elements
        n_el = max(1, int(max(n_el, head.n_vectors) * slice_frac))
        reqs.append(FBRequest(kind="relu", layer=head.name + "_relu",
                              req_rows=_maxlogic_rows(2, chip.input_bits),
                              req_cols=min(n_el, chip.array_cols),
                              n_vectors=n_el, window=2,
                              data_bits=chip.input_bits))
        consumes[len(reqs) - 1] = len(reqs) - 2 if res is not None else 0
    if smax is not None:
        reqs.append(FBRequest(kind="softmax", layer=smax.name,
                              req_rows=_maxlogic_rows(smax.n_elements, 16),
                              req_cols=min(max(smax.n_elements, 1), chip.array_cols),
                              n_elements=max(smax.n_elements, 2),
                              data_bits=16))   # fp16 softmax path (§IV-A2)
        consumes[len(reqs) - 1] = len(reqs) - 2
    return reqs, consumes, head


# ---------------------------------------------------------------------------
# HURRY simulation
# ---------------------------------------------------------------------------

def as_chip(chip) -> ChipConfig:
    """Accept a ChipConfig or anything with a ``.chip()`` derivation.

    ``repro_torch.api.HurryConfig`` is the unified front-door config;
    deriving through its ``.chip()`` keeps the HurryConfig -> ChipConfig
    mapping in one place without ``core`` importing ``api``.
    """
    derive = getattr(chip, "chip", None)
    return derive() if callable(derive) else chip


def simulate_hurry(layers: list[LayerSpec], chip: ChipConfig = ChipConfig(),
                   name: str = "hurry") -> SimReport:
    chip = as_chip(chip)
    acfg = ArrayConfig(chip.array_rows, chip.array_cols, chip.input_phases)
    em, am = EnergyModel(), AreaModel()
    planes = chip.weight_planes
    adc_bits = adc_bits_for(chip.array_rows, chip.cell_bits)

    execs: list[LayerExec] = []
    luts = 0.0
    dacs = 0.0
    snas = 0.0
    input_write_cells = 0.0
    prev_out_bytes = 3 * 32 * 32
    group_out: dict[str, float] = {}   # group-final layer -> out_bytes
    for group in layer_groups(layers):
        reqs, consumes, head = build_group_requests(group, chip)
        # graph-aware input traffic: a layer with explicit wiring (e.g. a
        # ResNet shortcut projection, or conv1 beside it) streams its
        # true producer's output, not the previous group's
        in_bytes = (group_out.get(head.input_from, prev_out_bytes)
                    if head.input_from else prev_out_bytes)
        plan = plan_array(reqs, chip.array_rows, chip.array_cols, consumes,
                          name=head.name)
        blocks = plan.blocks
        sched = schedule_array(blocks, acfg, name=head.name, pipelined=True)
        conv_fb = blocks[0]
        n_arrays = (math.ceil(max(head.gemm_rows, 1) / conv_fb.rows)
                    * math.ceil(max(head.gemm_cols_logical * planes, 1)
                                / conv_fb.cols))
        # FB bounding box = allocated cells (reconfigurability: the rest of
        # the array is free for the next group's overlapped write)
        bbox = sum(b.rows * b.cols for b in blocks)
        mapped = sum(b.mapped_cells for b in blocks)
        gemm_active = sum(sched.n_waves * c.read_cycles
                          for c in sched.wave_costs
                          if c.fb.kind in ("conv", "fc"))
        lut_ops = sum(2 * b.request.n_elements for b in blocks
                      if b.kind == "softmax")
        out_bytes = group[-1].out_bytes
        weight_cells = (max(head.gemm_rows, 1)
                        * max(head.gemm_cols_logical, 1) * planes)
        # input-stationary FB writes recur every wave (HMS)
        in_station = sum(sched.n_waves * c.write_cycles * c.fb.rows
                         for c in sched.wave_costs
                         if c.fb.kind not in ("conv", "fc")) * n_arrays
        input_write_cells += in_station
        luts += lut_ops
        dacs += sched.n_waves * chip.input_phases * conv_fb.rows * n_arrays
        snas += sched.n_waves * chip.input_phases * conv_fb.cols * n_arrays

        execs.append(LayerExec(
            name=head.name,
            # consecutive batch images stream through the FB pipeline, so
            # the fill cost amortizes over the batch
            compute_cycles=sched.steady_cycles
            + sched.fill_cycles / chip.batch,
            write_cells=weight_cells,
            write_cycles=conv_fb.cols,           # columns written per array,
            write_overlapped=True,               # in parallel across arrays
            in_bytes=in_bytes, out_bytes=out_bytes,
            arrays_per_replica=n_arrays,
            max_replicas=max(1, head.n_vectors),
            mapped_cells=mapped * n_arrays, alloc_cells=bbox * n_arrays,
            active_cell_cycles=sched.active_cell_cycles * n_arrays,
            adc_bits=adc_bits,
            adc_active_cycles=gemm_active * n_arrays,
            lut_ops=lut_ops))
        group_out[group[-1].name] = out_bytes
        prev_out_bytes = out_bytes

    ecfg = ExecConfig(n_slots=chip.n_arrays,
                      slot_cells=chip.array_rows * chip.array_cols,
                      n_adc_arrays=chip.n_arrays,
                      bus_bytes_per_cycle=chip.bus_bytes_per_cycle * chip.n_tiles,
                      batch=chip.batch, mlc_write_factor=1)
    res = run_layers(execs, ecfg)

    # --- energy --------------------------------------------------------------
    e = EnergyLedger()
    for bits, act, idle in res.adc_terms:
        e.adc += em.adc_energy_pj(bits, act, idle)
    e.dac = dacs * em.dac_pj
    e.sna = snas * em.sna_pj
    e.lut = luts * em.lut_pj
    e.cell_write = (res.write_cells_total + input_write_cells) * em.cell_write_pj
    e.cell_read = sum(L.active_cell_cycles for L in execs) * em.cell_read_fj * 1e-3
    io_bytes = sum(L.in_bytes + L.out_bytes for L in execs)
    weight_bytes = sum(L.write_cells for L in execs) / 8 / chip.batch
    e.edram = (io_bytes + weight_bytes) * em.edram_pj_byte
    e.bus = (io_bytes + weight_bytes) * em.bus_pj_byte

    # --- area ------------------------------------------------------------------
    a = AreaLedger(controller_mult=chip.controller_area_mult)
    n = chip.n_arrays
    a.array = n * am.array_mm2(chip.array_rows, chip.array_cols)
    a.adc = n * am.adc_mm2(adc_bits)
    a.dac = n * chip.array_rows * am.dac_mm2_per_lane
    a.sna_snh = n * chip.array_cols * (am.sna_mm2_per_lane + am.snh_mm2_per_lane)
    a.sram = n * (chip.ir_kb + chip.or_kb) / 1024 * am.sram_mm2_per_mb
    a.edram = chip.n_tiles * (chip.edram_kb_per_tile / 64) * am.edram_mm2_per_64kb
    a.lut = chip.n_tiles * am.lut_block_mm2

    # --- utilization -------------------------------------------------------------
    sp = res.spatial_per_layer
    mean_sp = sum(sp) / len(sp)
    std_sp = (sum((x - mean_sp) ** 2 for x in sp) / len(sp)) ** 0.5
    chip_cells = chip.n_arrays * chip.array_rows * chip.array_cols
    temporal = res.active_cell_cycles / (chip_cells * res.makespan_cycles)

    return SimReport(name=name, latency_cycles=res.makespan_cycles,
                     throughput_cycles=res.makespan_cycles,
                     energy=e, area=a, spatial_utilization=mean_sp,
                     spatial_utilization_std=std_sp,
                     temporal_utilization=min(temporal, 1.0), exec_result=res)
