"""Functional blocks (FBs) and their cycle models (paper §II-C, §III).

A functional block is a rectangular sub-region of one 512x512 ReRAM array,
carved out at runtime by the Block Activation Scheme.  Each FB executes one
CNN layer function *in situ*:

  conv / fc : GEMM, weight-stationary (HMS).  One read pass applies one
              input bit-phase to the FB rows and senses all FB columns in
              parallel; an int8 input vector therefore costs
              ``input_phases`` (=8) cycles.  Producing a conv layer's
              output needs one pass per im2col column vector (out_h*out_w
              of them), times the number of sequential mount rounds if the
              kernel matrix exceeds the FB capacity.
  res       : merged *under* the conv FB (paper Fig 4a): its rows hold the
              residual input bits and contribute current in the same read
              pass, so it adds ZERO read cycles; it must be (re)written
              with fresh residual inputs, costing ``cols`` cycles per
              refresh (paper: write cost = #columns).  Under BAS this
              write overlaps the conv FB's reads (Fig 3) — the pipeline
              model accounts for that.
  max / relu: "max logic" tournament (paper Fig 4b/c, refs [10][11]).  The
              paper's datum is 11 compare + 5 select cycles for one 2-bit
              pairwise compare; we generalize with the exact-at-datum fits
              compare(k) = 4k + 3 and select(k) = 2k + 1.  A p-element
              window needs ceil(log2 p) tournament rounds; windows are
              laid out across FB columns (Fig 5c) so all windows in the FB
              advance in parallel.  ReLU = one compare round against zero
              and can merge with the max FB (§II-C2).
  softmax   : tournament max over the logits (Eq. 1), then exp/log via the
              tile look-up table; per-element LUT ops are pipelined.

Cycle-model constants are centralized here and documented as calibrated
generalizations of the figures the paper states (it does not publish a
full per-op cycle table).

A copy of ``repro.core.functional_blocks``: the port imports nothing of
the JAX package, and this module is pure Python.
"""

from __future__ import annotations

import dataclasses
import math

# ---------------------------------------------------------------------------
# Cycle-model primitives
# ---------------------------------------------------------------------------

def compare_cycles(bits: int) -> int:
    """Max-logic pairwise compare of two ``bits``-bit values (11 @ 2-bit)."""
    return 4 * bits + 3


def select_cycles(bits: int) -> int:
    """Max-logic select after a compare (5 @ 2-bit)."""
    return 2 * bits + 1


def tournament_rounds(n: int) -> int:
    return max(1, math.ceil(math.log2(max(n, 2))))


@dataclasses.dataclass(frozen=True)
class FBRequest:
    """What a layer *needs* mapped — (bx, by) in Algorithm 2's notation."""

    kind: str                 # conv|fc|res|max|relu|softmax
    layer: str                # producing layer name
    req_rows: int             # bx: rows the operation needs
    req_cols: int             # by: cols the operation needs
    n_vectors: int = 1        # GEMM passes (e.g. out_h*out_w) or #windows
    window: int = 1           # pool window size (elements) for max/relu
    data_bits: int = 8
    n_elements: int = 1       # softmax length


@dataclasses.dataclass(frozen=True)
class FunctionalBlock:
    """A placed, sized FB — (nx, ny) in Algorithm 2's notation."""

    fb_id: int
    request: FBRequest
    rows: int
    cols: int
    # placement inside the array (filled by the sequence-pair decoder)
    row0: int = 0
    col0: int = 0

    @property
    def kind(self) -> str:
        return self.request.kind

    @property
    def cells(self) -> int:
        return self.rows * self.cols

    @property
    def mapped_cells(self) -> int:
        """Cells holding useful data, counting replicated kernel copies.

        Row-copies of a GEMM kernel share bitlines, so they time-share
        reads (no throughput gain) but they *are* mapped — HURRY uses them
        for wear-leveling and to avoid rewrites (spatial-utilization gain,
        §IV-B3).  Column-copies are concurrently readable (true
        parallelism, see ``col_parallelism``).
        """
        rr, rc = self.request.req_rows, self.request.req_cols
        if self.request.kind in ("conv", "fc"):
            mr = (self.rows // rr) * rr if self.rows >= rr else self.rows
            mc = (self.cols // rc) * rc if self.cols >= rc else self.cols
            return mr * mc
        return min(self.rows, rr) * min(self.cols, rc)

    def col_parallelism(self) -> int:
        """Concurrent GEMM copies on disjoint column groups."""
        return max(1, self.cols // max(self.request.req_cols, 1))

    # -- capacity -----------------------------------------------------------
    def mount_rounds(self) -> int:
        """Sequential remounts when the request exceeds the FB size."""
        r = math.ceil(self.request.req_rows / max(self.rows, 1))
        c = math.ceil(self.request.req_cols / max(self.cols, 1))
        return max(1, r) * max(1, c)

    # -- cycle model ---------------------------------------------------------
    def write_cycles(self) -> int:
        """Writing an FB costs cycles equal to its columns (paper §II-B)."""
        return self.cols

    def read_cycles_per_vector(self, input_phases: int = 8) -> int:
        """One GEMM pass: bit-serial input phases, columns sensed in parallel."""
        return input_phases

    def compute_cycles(self, input_phases: int = 8) -> int:
        """Total in-array compute cycles for this FB's whole layer slice."""
        req = self.request
        if req.kind in ("conv", "fc"):
            return req.n_vectors * self.read_cycles_per_vector(input_phases) \
                * self.mount_rounds()
        if req.kind == "res":
            return 0  # merged read; its cost is the overlapped write
        if req.kind in ("max", "relu"):
            per_round = compare_cycles(req.data_bits) + select_cycles(req.data_bits)
            rounds = tournament_rounds(req.window) if req.kind == "max" else 1
            # windows advance in parallel across FB columns (Fig 5c): one
            # tournament needs `window` leaf columns; ReLU compares against
            # a broadcast zero, one element per column.
            per_win_cols = max(req.window, 1) if req.kind == "max" else 1
            parallel = max(1, self.cols // per_win_cols)
            waves = math.ceil(req.n_vectors / parallel)
            return waves * rounds * per_round
        if req.kind == "softmax":
            per_round = compare_cycles(req.data_bits) + select_cycles(req.data_bits)
            max_cyc = tournament_rounds(req.n_elements) * per_round
            lut_cyc = 2 * req.n_elements  # exp then accumulate/log, pipelined
            return max_cyc + lut_cyc
        raise ValueError(f"unknown FB kind {req.kind}")

    def refresh_write_cycles(self) -> int:
        """Per-pass input rewrite cost for input-stationary FBs (HMS)."""
        if self.request.kind in ("res", "max", "relu", "softmax"):
            return self.write_cycles()
        return 0
