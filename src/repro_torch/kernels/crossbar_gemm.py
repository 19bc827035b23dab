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
and adds one to ``crossbar_gemm.launches``; for a CPU tensor it computes
the plain PyTorch version (``crossbar_gemm_exact_ref`` /
``crossbar_gemm_ref``).  Nothing falls back from the card to the plain
version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_MAX_SMEM = 232448          # bytes of shared memory a Hopper block can use


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
# the kernel
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("crossbar_gemm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.crossbar_gemm_exact.argtypes = [p, p, p, i, i, i, i, p]
    lib.crossbar_gemm_exact.restype = i
    lib.crossbar_gemm_sliced.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.crossbar_gemm_sliced.restype = i
    lib.crossbar_gemm_sliced_smem.argtypes = [i]
    lib.crossbar_gemm_sliced_smem.restype = i
    return lib


def _check_operands(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"crossbar_gemm takes int8 operands, got "
                        f"{x.dtype} and {w.dtype}")
    if not (x.dim() == w.dim() and x.dim() in (2, 3)
            and x.shape[-1] == w.shape[-2] and x.shape[:-2] == w.shape[:-2]):
        raise ValueError(f"crossbar_gemm: shapes {tuple(x.shape)} x "
                         f"{tuple(w.shape)} do not multiply")
    if x.device != w.device:
        raise ValueError(f"crossbar_gemm: operands on {x.device} and "
                         f"{w.device}")


def _launch(x: torch.Tensor, w: torch.Tensor, *, exact: bool, rows: int,
            adc_bits: int) -> torch.Tensor:
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("crossbar_gemm: the CUDA kernel takes contiguous "
                         "operands")
    M, K = x.shape[-2:]
    N = w.shape[-1]
    S = x.shape[0] if x.dim() == 3 else 1
    y = torch.empty(*x.shape[:-1], N, dtype=torch.int32, device=x.device)
    if y.numel() == 0 or K == 0:
        return y.zero_()
    if S > 65535:
        raise ValueError(f"crossbar_gemm: {S} slices exceed the grid's z "
                         "limit of 65535")
    lib = _lib()
    stream = _build.stream_handle()
    if exact:
        err = lib.crossbar_gemm_exact(x.data_ptr(), w.data_ptr(),
                                      y.data_ptr(), S, M, N, K, stream)
    else:
        chunks, words = -(-K // rows), -(-rows // 32)
        if lib.crossbar_gemm_sliced_smem(words) > _MAX_SMEM:
            raise ValueError(f"crossbar_gemm: rows={rows} needs more "
                             "shared memory than a block has")
        xp = torch.empty(S * M * chunks * 8 * words, dtype=torch.int32,
                         device=x.device)
        wp = torch.empty(S * N * chunks * 8 * words, dtype=torch.int32,
                         device=x.device)
        err = lib.crossbar_gemm_sliced(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), xp.data_ptr(),
            wp.data_ptr(), S, M, N, K, rows, (1 << adc_bits) - 1, stream)
    _build.check(lib, "crossbar_gemm", err)
    crossbar_gemm.launches += 1
    return y


def crossbar_gemm(x: torch.Tensor, w: torch.Tensor, *, adc_bits: int = 9,
                  rows: int = 512, exact: bool | None = None) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32 with HURRY semantics;
    (S, M, K) x (S, K, N) -> (S, M, N) runs S independent GEMMs.

    ``exact=None`` auto-dispatches (module docstring); ``exact=True``
    raises ``ValueError`` when ADC saturation could fire.  CUDA operands
    run the kernel (one launch for all slices), CPU operands the plain
    version.
    """
    _check_operands(x, w)
    rows = max(1, min(rows, x.shape[-1]))
    if exact is None:
        exact = not clip_possible(rows, adc_bits)
    elif exact and clip_possible(rows, adc_bits):
        raise ValueError(
            f"exact=True but ADC clipping can fire: rows={rows} > "
            f"2^{adc_bits} - 1 = {(1 << adc_bits) - 1}; use the sliced path")
    if x.is_cuda:
        return _launch(x, w, exact=exact, rows=rows, adc_bits=adc_bits)
    if exact:
        return crossbar_gemm_exact_ref(x, w)
    return crossbar_gemm_ref(x, w, adc_bits=adc_bits, rows=rows)


crossbar_gemm.launches = 0
