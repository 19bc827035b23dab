"""HURRY chip geometry and per-group FB requests (paper §II-A, §III-C).

The part of ``repro.core.simulator`` the program compiler needs:
``ChipConfig`` (tiles x IMAs of 512x512 1-bit-cell arrays) and
``build_group_requests``, which turns one GEMM layer group into the FB
requests + consumer edges that Algorithms 1 & 2 place.  The analytical
chip model itself (``simulate_hurry`` with its area / BAS / energy /
execution modules) is not part of the port yet.  Copied, because the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses

from .functional_blocks import FBRequest, tournament_rounds
from .workload import LayerSpec


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
