"""Model-aware scheduling: Algorithms 1 & 2 + sequence-pair decoding (§III).

Algorithm 1 (FB Relative Positioning) builds a *sequence pair* [Murata'96]:
consumers of a producer's output ("accumulative operations") are placed
BELOW the producer so the producer's bitline outputs are read directly as
the consumer's inputs; unrelated FBs are placed to the RIGHT.  The paper's
pseudocode loops j over all predecessors and would insert ``i`` repeatedly;
we disambiguate with first-match-wins (one insertion per FB), which
preserves the stated intent ("if FB2 uses FB1's output, it is placed below
FB1").

Sequence-pair semantics used here (standard Murata convention, y measured
downward so "below" = larger y):
  a LEFT-OF b   iff a precedes b in seq1 AND a precedes b in seq2
  a ABOVE b     iff a precedes b in seq1 AND a succeeds b in seq2
Coordinates are decoded by longest-path over the two constraint graphs.

Algorithm 2 (FB Size Balancing) greedily scales FBs (in integer multiples
of their required size) subject to the paper's feasibility predicate:
  (1) sum of FB rows fits the array,  (2) sum of FB cols fits the array,
  (3) producer parallelism never exceeds consumer capacity
      (nx_{i-1}/bx_{i-1}) * (ny_{i-1}/by_{i-1}) <= ny_i / by_{i-1}.
The predicate is exported standalone (``balance_feasible``).

A copy of ``repro.core.scheduling``: the port imports nothing of the JAX
package, and this module is pure Python.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from .functional_blocks import FBRequest, FunctionalBlock


# ---------------------------------------------------------------------------
# Algorithm 1 — FB relative positioning (sequence pair)
# ---------------------------------------------------------------------------

def fb_relative_positioning(requests: Sequence[FBRequest],
                            consumes: dict[int, int]) -> tuple[list[int], list[int]]:
    """Paper Algorithm 1.

    ``consumes[i] = j`` means FB i performs an accumulative operation on
    FB j's output (i consumes j).  Returns (seq1, seq2) of FB indices.
    """
    n = len(requests)
    if n == 0:
        return [], []
    seq1, seq2 = [0], [0]
    for i in range(1, n):
        j = consumes.get(i, None)
        if j is not None and j in seq2:
            # consumer: below its producer -> append to seq1, left of j in seq2
            seq1.append(i)
            seq2.insert(seq2.index(j), i)
        else:
            # independent: to the right of the rightmost block
            k = seq1[-1]
            seq1.append(i)
            # after k in seq2 as well => strictly right-of (Murata)
            seq2.insert(seq2.index(k) + 1, i)
    return seq1, seq2


def decode_sequence_pair(seq1: Sequence[int], seq2: Sequence[int],
                         sizes: Sequence[tuple[int, int]]) -> list[tuple[int, int]]:
    """Longest-path decode of a sequence pair -> (row0, col0) per block.

    ``sizes[i] = (rows_i, cols_i)``.  y (row0) grows downward.
    """
    n = len(sizes)
    p1 = {b: k for k, b in enumerate(seq1)}
    p2 = {b: k for k, b in enumerate(seq2)}
    x = [0] * n
    y = [0] * n
    order = sorted(range(n), key=lambda b: p1[b])
    for b in order:
        for a in range(n):
            if a == b:
                continue
            if p1[a] < p1[b] and p2[a] < p2[b]:      # a left-of b
                x[b] = max(x[b], x[a] + sizes[a][1])
            if p1[a] < p1[b] and p2[a] > p2[b]:      # a above b
                y[b] = max(y[b], y[a] + sizes[a][0])
    return [(y[b], x[b]) for b in range(n)]


# ---------------------------------------------------------------------------
# Algorithm 2 — FB size balancing
# ---------------------------------------------------------------------------

def _parallelism(nx: int, ny: int, bx: int, by: int) -> int:
    return max(1, nx // max(bx, 1)) * max(1, ny // max(by, 1))


def balance_feasible(sizes: Sequence[tuple[int, int]],
                     requests: Sequence[FBRequest],
                     arr_rows: int, arr_cols: int,
                     consumes: dict[int, int] | None = None) -> bool:
    """Paper Algorithm 2's constraint set over a full sizing proposal.

    Capacity is checked on the *placed* bounding box (Algorithm 1 +
    sequence-pair decode), which is the exact form of the paper's
    "all FBs collectively fit within the total array size"; the rate
    constraint is the paper's third conjunct.
    """
    consumes = consumes or {}
    seq1, seq2 = fb_relative_positioning(requests, consumes)
    coords = decode_sequence_pair(seq1, seq2, sizes)
    for (r0, c0), (r, c) in zip(coords, sizes):
        if r0 + r > arr_rows or c0 + c > arr_cols:
            return False
    for i in range(1, len(sizes)):
        bx0, by0 = requests[i - 1].req_rows, requests[i - 1].req_cols
        nx0, ny0 = sizes[i - 1]
        ny1 = sizes[i][1]
        if _parallelism(nx0, ny0, bx0, by0) > max(1, ny1 // max(by0, 1)):
            return False
    return True


def fb_size_balancing(requests: Sequence[FBRequest],
                      arr_rows: int = 512, arr_cols: int = 512,
                      consumes: dict[int, int] | None = None
                      ) -> list[FunctionalBlock]:
    """Paper Algorithm 2 (greedy): start at required size, grow while feasible.

    Start each FB at its required size (capped by the array); if the placed
    set does not fit, shrink the head GEMM FB (it is the dominant one) until
    it does.  Then grow greedily — the FB with the *lowest* current
    parallelism first (rate balancing) — in integer multiples of the
    required size, stopping when no single growth keeps the predicate true.
    """
    n = len(requests)
    if n == 0:
        return []
    consumes = consumes or {}
    sizes = [[min(r.req_rows, arr_rows), min(r.req_cols, arr_cols)]
             for r in requests]

    # shrink FBs along the overflowing axis until the placement fits
    def fits() -> bool:
        return balance_feasible([tuple(s) for s in sizes], requests,
                                arr_rows, arr_cols, consumes)

    def overflow() -> tuple[int, int]:
        seq1, seq2 = fb_relative_positioning(requests, consumes)
        coords = decode_sequence_pair(seq1, seq2, [tuple(s) for s in sizes])
        ro = max((r0 + s[0]) - arr_rows for (r0, _), s in zip(coords, sizes))
        co = max((c0 + s[1]) - arr_cols for (_, c0), s in zip(coords, sizes))
        return max(ro, 0), max(co, 0)

    guard = 0
    while not fits() and guard < 256:
        guard += 1
        ro, co = overflow()
        if ro == 0 and co == 0:
            break   # infeasible for a non-capacity reason; growth loop skips
        axis = 0 if ro >= co else 1
        cand = max(range(n), key=lambda i: sizes[i][axis])
        if sizes[cand][axis] <= 1:
            axis = 1 - axis
            cand = max(range(n), key=lambda i: sizes[i][axis])
            if sizes[cand][axis] <= 1:
                break
        sizes[cand][axis] = max(1, int(sizes[cand][axis] * 0.85))

    improved = True
    while improved:
        improved = False
        order = sorted(range(n), key=lambda i: _parallelism(
            sizes[i][0], sizes[i][1], requests[i].req_rows, requests[i].req_cols))
        for i in order:
            r = requests[i]
            for grow in ((max(r.req_rows, 1), 0), (0, max(r.req_cols, 1))):
                cand = (min(sizes[i][0] + grow[0], arr_rows),
                        min(sizes[i][1] + grow[1], arr_cols))
                if cand == tuple(sizes[i]):
                    continue
                proposal = [tuple(s) for s in sizes]
                proposal[i] = cand
                if balance_feasible(proposal, requests, arr_rows, arr_cols,
                                    consumes):
                    sizes[i] = list(cand)
                    improved = True
                    break
            if improved:
                break
    return [FunctionalBlock(fb_id=i, request=requests[i],
                            rows=sizes[i][0], cols=sizes[i][1])
            for i in range(n)]


def _decode_place(blocks: Sequence[FunctionalBlock],
                  consumes: dict[int, int]
                  ) -> tuple[tuple[FunctionalBlock, ...],
                             tuple[int, ...], tuple[int, ...]]:
    """Algorithm 1 + sequence-pair decode -> (placed FBs, seq1, seq2)."""
    reqs = [b.request for b in blocks]
    seq1, seq2 = fb_relative_positioning(reqs, consumes)
    coords = decode_sequence_pair(seq1, seq2, [(b.rows, b.cols) for b in blocks])
    placed = tuple(dataclasses.replace(b, row0=coords[i][0], col0=coords[i][1])
                   for i, b in enumerate(blocks))
    return placed, tuple(seq1), tuple(seq2)


def place_fbs(blocks: Sequence[FunctionalBlock],
              consumes: dict[int, int]) -> list[FunctionalBlock]:
    """Run Algorithm 1 + sequence-pair decode, return placed FBs."""
    return list(_decode_place(blocks, consumes)[0])


# ---------------------------------------------------------------------------
# ArrayPlan — the decoded plan of one array, the structure every consumer
# (simulator, program compiler, visualizers) reads instead of re-running
# the sequence-pair decode themselves.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ArrayPlan:
    """One array's sized + placed FB chain with the decoded coordinates.

    ``blocks`` carry Algorithm 2's sizes and the sequence-pair decode's
    (row0, col0) origins; ``seq1``/``seq2`` are Algorithm 1's sequence
    pair, exported so the relative-position constraints stay inspectable
    alongside the absolute coordinates.
    """

    name: str
    arr_rows: int
    arr_cols: int
    blocks: tuple[FunctionalBlock, ...]
    seq1: tuple[int, ...]
    seq2: tuple[int, ...]

    @property
    def coords(self) -> tuple[tuple[int, int], ...]:
        """Decoded (row0, col0) per FB, in request order (y grows downward)."""
        return tuple((b.row0, b.col0) for b in self.blocks)

    @property
    def sizes(self) -> tuple[tuple[int, int], ...]:
        """Balanced (rows, cols) per FB, in request order."""
        return tuple((b.rows, b.cols) for b in self.blocks)

    def block_of(self, *kinds: str) -> FunctionalBlock | None:
        """First placed FB whose kind is in ``kinds`` (e.g. "conv", "fc")."""
        for b in self.blocks:
            if b.kind in kinds:
                return b
        return None


def plan_array(requests: Sequence[FBRequest],
               arr_rows: int = 512, arr_cols: int = 512,
               consumes: dict[int, int] | None = None,
               name: str = "array") -> ArrayPlan:
    """Algorithm 2 sizing + Algorithm 1 placement -> one ``ArrayPlan``."""
    consumes = consumes or {}
    blocks = fb_size_balancing(requests, arr_rows, arr_cols, consumes)
    placed, seq1, seq2 = _decode_place(blocks, consumes)
    return ArrayPlan(name=name, arr_rows=arr_rows, arr_cols=arr_cols,
                     blocks=placed, seq1=seq1, seq2=seq2)
