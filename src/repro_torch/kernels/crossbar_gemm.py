"""HURRY crossbar GEMM: (M, K) int8 x (K, N) int8 -> (M, N) int32.

The port of ``repro.kernels.crossbar_gemm`` (the Pallas kernel, both its
``_kernel_exact`` and ``_kernel_sliced`` bodies) and of its oracles in
``repro.kernels.ref``.  A leading slice axis, (S, M, K) x (S, K, N) ->
(S, M, N), runs every slice in one launch: what ``jax.vmap`` over the
Pallas call computes for attention's per-(batch, head) mounts.
``crossbar_gemm`` dispatches exactly as the JAX wrapper does:

* ``rows = min(rows, K)``; the ADC can clip iff ``rows > 2^adc_bits - 1``
  (``clip_possible``);
* ``exact=None`` takes the exact branch (a plain int8 -> int32 GEMM,
  bit-identical because no clip can fire) when no clip is possible and
  the faithful sliced branch otherwise; ``exact=False`` forces the
  sliced branch; ``exact=True`` raises ``ValueError`` if a clip could
  fire.

For a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/crossbar_gemm.cu`` (its header says what bounds it on the H100)
under the plan ``exact_plan`` picks from the shape on the exact branch
(64 x 64 tiles with a K split, or wide tiles in N-first order, which
read x from device memory once) and counts it in
``launches.crossbar_gemm`` (``repro_torch.trace``); for a CPU tensor it
computes the plain PyTorch version (``crossbar_gemm_exact_ref`` /
``crossbar_gemm_ref``).  Nothing falls back from the card to the plain
version.

The kernel layout.  The kernels (``wgmma`` on s8) take both operands
K-major with 16-byte-aligned rows: x as (..., M, Kk) and the weight
transposed, wt (..., N, Kk), K zero-padded to Kk: a multiple of 32 on
the exact branch, chunk by chunk on the sliced branch (each
``rows``-row chunk to a multiple of 32 rows, so that no k-step straddles
an ADC chunk).  Zero rows add nothing to a product or to a bitline
count, so the padding is exact.  ``mount_weight`` builds that
kernel-layout weight, and ``kernel_layout`` pads a K-major operand into
it.  ``call_layout`` alone decides a call's branch and Kk, for the
wrapper and for what lays operands out ahead of it: the packer mounts
each static stage's weight once (``PackedStage.wt``) and the executor
quantizes activations straight into the layout.  K is the call's own: a
static stage passes its logical K on the exact branch, not the K of its
whole mounts, so no zero rows of a part-filled mount are written or
multiplied (``program.pack.layout_k``); the last TMA slab of a K that is
no multiple of 128 is part-filled, and the tensor map fills the rest
with zeros.  Passed a plain (K, N) weight without ``wt``, the wrapper
lays it out itself in one extra launch (and pads x likewise where x is
not already in the layout): those helper launches do not count as
``crossbar_gemm`` launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import trace

from . import _build


def clip_possible(rows: int, adc_bits: int) -> bool:
    """True iff an ADC clip can ever fire for ``rows``-row chunks.

    A bitline count is a sum of at most ``rows`` 1-bit products, and the
    ADC digitizes ``[0, 2^adc_bits - 1]`` exactly, so clipping is
    impossible iff ``rows <= 2^adc_bits - 1``.
    """
    return rows > (1 << adc_bits) - 1


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and what the kernel is held against)
# ---------------------------------------------------------------------------

def crossbar_gemm_exact_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain int8 -> int32 GEMM (2-D, or batched over a leading axis),
    computed in float64.

    Exact: |sum| <= K * 2^14 < 2^53.  (``int8 @ int8`` in torch returns
    int8 and wraps silently, so it is never used.)
    """
    return (x.double() @ w.double()).to(torch.int32)


def crossbar_gemm_ref(x: torch.Tensor, w: torch.Tensor, *,
                      adc_bits: int = 9, rows: int = 512) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32, HURRY array semantics
    (or batched: (S, M, K) x (S, K, N) -> (S, M, N), slice by slice).

    K is processed in chunks of ``rows`` (zero-padded); each (input bit,
    weight bit) plane pair's chunk count is clipped to the ADC range
    ``[0, 2^adc_bits - 1]`` before the shift-and-add, whose MSB planes
    weigh -128.  Counts are float64 products of {0, 1} planes (exact);
    the weight planes are stacked along N so each input plane takes one
    batched product over the slices and chunks.
    """
    if x.dim() == 2:
        return _sliced_ref(x[None], w[None], adc_bits, rows)[0]
    return _sliced_ref(x, w, adc_bits, rows)


def _sliced_ref(x: torch.Tensor, w: torch.Tensor, adc_bits: int,
                rows: int) -> torch.Tensor:
    S, M, K = x.shape
    N = w.shape[-1]
    adc_max = (1 << adc_bits) - 1
    chunks = -(-K // rows)
    pad = chunks * rows - K
    xu = torch.nn.functional.pad(x.to(torch.int32) & 0xFF, (0, pad))
    wu = torch.nn.functional.pad(w.to(torch.int32) & 0xFF, (0, 0, 0, pad))
    xu = xu.reshape(S, M, chunks, rows).transpose(1, 2)       # (S, C, M, R)
    wu = wu.reshape(S, chunks, rows, N)                       # (S, C, R, N)
    bits = torch.arange(8, device=x.device, dtype=torch.int32)
    s = (1 << bits.long()) - 256 * (bits == 7)     # 1, 2, ..., 64, -128
    # weight planes along N: (S, C, R, 8, N) -> (S, C, R, 8N)
    wb = ((wu[..., None, :] >> bits[:, None]) & 1)
    wb = wb.reshape(S, chunks, rows, 8 * N).double()
    out = torch.zeros(S, M, N, dtype=torch.int64, device=x.device)
    for i in range(8):
        xb = ((xu >> i) & 1).double()                         # (S, C, M, R)
        counts = (xb @ wb).clamp_(0, adc_max)                 # ADC clip
        counts = counts.to(torch.int64).reshape(S, chunks, M, 8, N)
        out += s[i] * (counts * s[:, None]).sum(dim=(1, 3))
    return out.to(torch.int32)


# ---------------------------------------------------------------------------
# the kernel layout
# ---------------------------------------------------------------------------

class CallLayout(NamedTuple):
    """How ``crossbar_gemm`` runs a call of contraction length K
    (``call_layout``)."""

    rows: int       # min(rows, K): the rows an ADC read sums
    exact: bool     # the branch
    kk: int         # the kernel layout's K
    rows32: int     # a chunk's rows in the sliced layout: up32(rows)


def call_layout(K: int, rows: int = 512, adc_bits: int = 9,
                exact: bool | None = None) -> CallLayout:
    """The layout of a call of contraction length K, as the wrapper
    dispatches it (module docstring): rows = min(rows, K), the branch,
    Kk (up32(K) on the exact branch, chunks * up32(rows) on the sliced
    one) and up32(rows); raises for ``exact=True`` where a clip could
    fire.  The one place the branch and the layout are decided."""
    rows = max(1, min(rows, K))
    if exact is None:
        exact = not clip_possible(rows, adc_bits)
    elif exact and clip_possible(rows, adc_bits):
        raise ValueError(
            f"exact=True but ADC clipping can fire: rows={rows} > "
            f"2^{adc_bits} - 1 = {(1 << adc_bits) - 1}; use the sliced path")
    rows32 = -(-rows // 32) * 32
    kk = -(-K // 32) * 32 if exact else -(-K // rows) * rows32
    return CallLayout(rows, exact, kk, rows32)


def _layout(t: torch.Tensor, lay: CallLayout) -> torch.Tensor:
    """(..., R, k) K-major, k <= K, -> (..., R, lay.kk), zero-padded;
    ``t`` itself where nothing needs padding."""
    k, rows, r32 = t.shape[-1], lay.rows, lay.rows32
    if lay.exact:
        return F.pad(t, (0, lay.kk - k)) if lay.kk != k else t
    chunks = lay.kk // r32
    if r32 == rows and k == chunks * rows:
        return t
    t = F.pad(t, (0, chunks * rows - k)).unflatten(-1, (chunks, rows))
    return F.pad(t, (0, r32 - rows)).flatten(-2)


def kernel_layout(t: torch.Tensor, K: int, *, rows: int = 512,
                  adc_bits: int = 9,
                  exact: bool | None = None) -> torch.Tensor:
    """A K-major int8 operand (..., R, k), k <= K (the call's contraction
    length), zero-padded into the kernel layout (..., R, Kk): Kk a
    multiple of 32 on the exact branch, chunks * roundup(rows, 32) on the
    sliced branch.

    x of a call goes in as it is; a (K, N) weight goes in transposed
    (``mount_weight``).  Returns ``t`` itself where no padding is needed.
    """
    return _layout(t, call_layout(K, rows, adc_bits, exact))


def mount_weight(w: torch.Tensor, *, rows: int = 512, adc_bits: int = 9,
                 exact: bool | None = None) -> torch.Tensor:
    """A (..., K, N) int8 weight in the kernel layout: wt (..., N, Kk)
    (``kernel_layout``), contiguous, what ``crossbar_gemm(..., wt=)``
    takes."""
    return kernel_layout(w.mT, w.shape[-2], rows=rows, adc_bits=adc_bits,
                         exact=exact).contiguous()


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

SM_COUNT = 132               # H100 SXM
_BK = 128                    # bytes of K a k-slab
_WIDE_BN = (256, 192, 128, 64)


class ExactPlan(NamedTuple):
    """How an exact call runs: output tiles of ``bm`` x ``bn`` and
    ``splits`` blocks sharing a tile along K.  ``bm`` 64 is the 64 x 64
    design (a slice axis, a K split); ``bm`` 128 the wide persistent
    tiles of a 2-D call, walked in N-first order (``csrc/crossbar_gemm.cu``'s
    header)."""

    bm: int
    bn: int
    splits: int


def exact_plan(S: int, M: int, N: int, kk: int) -> ExactPlan:
    """The plan of an exact call of S slices of (M, kk) x (kk, N), kk the
    kernel layout's K, from the shape alone.

    A 2-D call whose wide tiles fill the SMs (at least one tile an SM)
    takes them, at the width among 256, 192, 128 and 64 that needs the
    fewest column tiles, each of which loads every x strip, and of those
    pads N least; the N-first order then reads x from device memory once.
    Every other call takes ``tile64_plan``: on an H100 the wide tiles of
    calls that fill fewer SMs take up to 1.5 times as long (PERF.md
    section 5)."""
    if S == 1:
        plan = wide_plan(N)
        if -(-M // 128) * -(-N // plan.bn) >= SM_COUNT:
            return plan
    return tile64_plan(S, M, N, kk)


def wide_plan(N: int) -> ExactPlan:
    """The wide tiles for N columns: the width among 256, 192, 128 and 64
    that needs the fewest column tiles and, of those, pads N least."""
    return ExactPlan(128, min(_WIDE_BN, key=lambda b: (-(-N // b),
                                                       -(-N // b) * b)), 1)


def tile64_plan(S: int, M: int, N: int, kk: int) -> ExactPlan:
    """64 x 64 tiles: where they fill at most a quarter of the SMs and K
    has at least 8 slabs, K split into enough parts to fill every SM
    once, at least 2 slabs each, with no empty part."""
    tiles = S * -(-M // 64) * -(-N // 64)
    nk = -(-kk // _BK)
    if 4 * tiles > SM_COUNT or nk < 8:
        return ExactPlan(64, 64, 1)
    split = max(1, min(-(-SM_COUNT // tiles), nk // 2))
    kps = -(-nk // split)
    return ExactPlan(64, 64, -(-nk // kps))


def x_load_bytes(S: int, M: int, N: int, kk: int) -> int:
    """The bytes of x that an exact call's plan loads into shared memory:
    each x strip once for each column tile that reads it."""
    return S * M * kk * -(-N // exact_plan(S, M, N, kk).bn)


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C entries' argument and result types on a loaded
    ``crossbar_gemm`` library (also a variant build of it)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.crossbar_gemm_exact.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
    lib.crossbar_gemm_exact.restype = i
    lib.crossbar_gemm_sliced.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
    lib.crossbar_gemm_sliced.restype = i
    lib.crossbar_gemm_sliced_splits.argtypes = [i, i, i, i]
    lib.crossbar_gemm_sliced_splits.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return declare(_build.load("crossbar_gemm"))


def _check_operands(x: torch.Tensor, w: torch.Tensor | None,
                    wt: torch.Tensor | None, K: int) -> None:
    """x against the right operand: ``w`` (K, N), or without it ``wt``,
    which x must then match in the kernel layout."""
    rhs = w if w is not None else wt
    if x.dtype != torch.int8 or rhs.dtype != torch.int8:
        raise TypeError(f"crossbar_gemm takes int8 operands, got "
                        f"{x.dtype} and {rhs.dtype}")
    k_ok = (x.shape[-1] == K and w is not None) or (
        wt is not None and x.shape[-1] == wt.shape[-1])
    if not (x.dim() == rhs.dim() and x.dim() in (2, 3) and k_ok
            and x.shape[:-2] == rhs.shape[:-2]):
        raise ValueError(f"crossbar_gemm: shapes {tuple(x.shape)} x "
                         f"{tuple(rhs.shape)} do not multiply")
    if x.device != rhs.device:
        raise ValueError(f"crossbar_gemm: operands on {x.device} and "
                         f"{rhs.device}")


def _check_wt(wt: torch.Tensor, x: torch.Tensor, N: int, kk: int) -> None:
    want = (*x.shape[:-2], N, kk)
    if wt.dtype != torch.int8 or tuple(wt.shape) != want:
        raise ValueError(f"crossbar_gemm: wt {wt.dtype} {tuple(wt.shape)} "
                         f"is not the kernel layout int8 {want}")
    if wt.device != x.device:
        raise ValueError(f"crossbar_gemm: wt on {wt.device}, x on "
                         f"{x.device}")


def splits(S: int, M: int, N: int, kk: int, *, exact: bool,
           rows32: int = 32) -> int:
    """The K split (blocks sharing one output tile) that the kernel takes
    for a call of this shape in the kernel layout: slabs of K on the exact
    branch (``exact_plan``), ADC chunks of ``rows32`` on the sliced
    branch."""
    if exact:
        return exact_plan(S, M, N, kk).splits
    return _lib().crossbar_gemm_sliced_splits(S, M, N, kk // rows32)


def _launch(x: torch.Tensor, wt: torch.Tensor, N: int, *, exact: bool,
            rows: int, adc_bits: int, split: int = 0,
            plan: ExactPlan | None = None) -> torch.Tensor:
    """One kernel launch on operands already in the kernel layout; on the
    exact branch ``plan`` forces the plan (None: ``exact_plan``), on the
    sliced branch ``split`` > 0 forces the chunk split (0: the kernel's
    own choice)."""
    if not (x.is_contiguous() and wt.is_contiguous()):
        raise ValueError("crossbar_gemm: the CUDA kernel takes contiguous "
                         "operands")
    M, kk = x.shape[-2:]
    S = x.shape[0] if x.dim() == 3 else 1
    y = torch.empty(*x.shape[:-1], N, dtype=torch.int32, device=x.device)
    if y.numel() == 0 or kk == 0:
        return y.zero_()
    if S > 65535:
        raise ValueError(f"crossbar_gemm: {S} slices exceed the grid's z "
                         "limit of 65535")
    lib = _lib()
    stream = _build.stream_handle()
    if exact:
        plan = plan or exact_plan(S, M, N, kk)
        err = lib.crossbar_gemm_exact(x.data_ptr(), wt.data_ptr(),
                                      y.data_ptr(), S, M, N, kk, *plan,
                                      stream)
    else:
        err = lib.crossbar_gemm_sliced(
            x.data_ptr(), wt.data_ptr(), y.data_ptr(), S, M, N, kk,
            -(-rows // 32) * 32, (1 << adc_bits) - 1, split, stream)
    _build.check(lib, "crossbar_gemm", err)
    trace.count("launches.crossbar_gemm")
    return y


def crossbar_gemm(x: torch.Tensor, w: torch.Tensor | None = None, *,
                  adc_bits: int = 9, rows: int = 512,
                  exact: bool | None = None,
                  wt: torch.Tensor | None = None,
                  K: int | None = None) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32 with HURRY semantics;
    (S, M, K) x (S, K, N) -> (S, M, N) runs S independent GEMMs.

    ``exact=None`` auto-dispatches (module docstring); ``exact=True``
    raises ``ValueError`` when ADC saturation could fire.  ``wt`` is the
    weight already in the kernel layout (``mount_weight(w, ...)`` with the
    same rows, adc_bits and exact); with it, x may come in the kernel
    layout as well, (..., M, Kk).  ``w`` may be left out where ``wt`` and
    the contraction length ``K`` are given (x then in the kernel layout):
    the dynamic stages' right operand is mounted straight into the layout
    and has no (K, N) form.  CUDA operands run the kernel (one launch for
    all slices), CPU operands the plain version.
    """
    if w is None and (wt is None or K is None):
        raise ValueError("crossbar_gemm: without w, pass wt and K")
    if w is not None:
        K = w.shape[-2]
    N = w.shape[-1] if w is not None else wt.shape[-2]
    _check_operands(x, w, wt, K)
    lay = call_layout(K, rows, adc_bits, exact)
    if wt is not None:
        _check_wt(wt, x, N, lay.kk)
    if x.is_cuda:
        if wt is None:        # lay the weight out here: one helper launch
            wt = _layout(w.mT, lay).contiguous()
        if x.shape[-1] != lay.kk:
            x = _layout(x, lay)
        return _launch(x.contiguous(), wt, N, exact=lay.exact,
                       rows=lay.rows, adc_bits=adc_bits)
    rows = lay.rows
    if w is None or x.shape[-1] != K:   # x in the kernel layout: chunks of
        w, rows = wt.mT, lay.rows32     # up32(rows) rows
    if lay.exact:
        return crossbar_gemm_exact_ref(x, w)
    return crossbar_gemm_ref(x, w, adc_bits=adc_bits, rows=rows)
