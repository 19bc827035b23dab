"""Quantize a stage's left operand straight into ``crossbar_gemm``'s layout.

Not the port of a Pallas kernel: the port of what XLA makes of the JAX
executor's chain under ``jax.jit``.  There, per stage, ``im2col``
(``src/repro/program/execute.py:148``), ``quantize_symmetric`` (``:160``)
and the zero pad to full mounts (``:164``) fuse into one pass over the
stage's input.  ``quantize_layout`` computes the same function in one
call: for a stage input ``x`` it returns ``(x8, amax)``,

* ``amax``, ``max |x|`` over the elements of the reference's operand (a
  float32 0-d tensor, or one per slice with ``per_slice=True``);
* ``x8``, ``clip(round(x / scale), -qmax-1, qmax)`` as int8 with
  ``scale = quantize_scale(amax, bits)``, laid out as ``kernel_layout``
  lays out a K-major operand of contraction length ``K``: (..., R, Kk),
  Kk = up32(K) on the exact branch, chunks * up32(rows) on the sliced
  branch, zeros wherever no source column lands.

Two gather modes:

* ``conv=(k, stride, pad)``: ``x`` is NHWC (N, H, W, C); the operand is
  its patch matrix (N*OH*OW, C*k*k), columns in the (C, kh, kw) order of
  ``conv_general_dilated_patches`` (which ``pack_weight``'s layout
  matches);
* otherwise ``x`` is a (R, k), (S, R, k) or (A, B, R, k) view, read
  through its strides as it lies (the fc flatten, the sequence stages'
  tokens, attention's per-(batch, head) left operands; the Q heads are a
  permuted view of the fused projection).

For a CUDA tensor the wrapper launches ``csrc/quantize_layout.cu`` (two
passes: the amax, then quantize and scatter) and adds one to
``quantize_layout.launches``; for a CPU tensor it computes the plain
version, ``quantize_layout_ref``.  Nothing falls back from the card to
the plain version.

Where it can go wrong, and what holds it (``tests/
test_torch_quantize_layout.py`` against the JAX package's jitted chain,
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 29 on the card):

1. pixels that no patch reads: a 1x1 stride-2 conv's patch matrix holds
   only even rows and columns, so the amax walks the covered pixels
   (``covered``), not the whole input (the zero pad of a conv cannot
   raise a maximum of |x| and is skipped);
2. the division: ``x / scale`` is a correctly rounded division, not
   ``x * (1 / scale)``, and ``round`` goes half to even;
3. graph capture: no host sync, no ``.item()``, outputs allocated by
   torch, the launch on the current stream;
4. the sliced layout: column k goes to ``(k // rows) * up32(rows) +
   k % rows``;
5. ``input_bits`` 4 to 8: ``qmax`` comes from ``bits``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from .crossbar_gemm import _branch, _kernel_k, _up32

AMAX_FLOOR = 1e-8


def qmax(bits: int) -> int:
    """The largest code of a symmetric ``bits``-bit quantizer."""
    return (1 << (bits - 1)) - 1


def inv_qmax(bits: int) -> float:
    """``f32(1 / qmax)``: the constant jitted XLA multiplies by for
    ``/ qmax`` (``repro_torch.core.crossbar``'s module docstring)."""
    return float(np.float32(1.0 / qmax(bits)))


def quantize_scale(amax: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Symmetric quantization scale from a per-tensor ``max(|x|)``.

    ``max(amax, 1e-8) * f32(1/qmax)``: the reciprocal form jitted XLA
    compiles ``max(amax, 1e-8) / qmax`` into.
    """
    return torch.clamp_min(amax, AMAX_FLOOR) * inv_qmax(bits)


def conv_out(n: int, k: int, stride: int, pad: int) -> int:
    """Output height (or width) of a ``k``-tap window over ``n`` pixels."""
    return (n + 2 * pad - k) // stride + 1


def covered(n: int, k: int, stride: int, pad: int) -> list[slice]:
    """The input rows (or columns) that some window reads, as slices.

    Row ``t`` is read iff ``t = o * stride - pad + d`` for an output ``o``
    and a tap ``d < k``.  With ``k >= stride`` the windows leave no gap
    and the rows form one range; with ``k < stride`` (a 1x1 stride-2
    projection) they are ``k`` progressions of step ``stride``.
    """
    n_out = conv_out(n, k, stride, pad)
    if k >= stride:
        return [slice(max(0, -pad),
                      min(n, (n_out - 1) * stride - pad + k))]
    out = []
    for d in range(k):
        o = -(-max(0, pad - d) // stride)   # first output whose tap lands
        first = o * stride - pad + d
        stop = min(n, (n_out - 1) * stride - pad + d + 1)
        if first < stop:
            out.append(slice(first, stop, stride))
    return out


def _geometry(x: torch.Tensor, K: int,
              conv: tuple[int, int, int] | None) -> tuple[int, tuple]:
    """(source columns, output shape before the layout) of a call;
    raises on what neither mode takes."""
    if x.dtype != torch.float32:
        raise TypeError(f"quantize_layout takes float32, got {x.dtype}")
    if conv is not None:
        if x.dim() != 4:
            raise ValueError(f"quantize_layout: a conv input is NHWC, got "
                             f"{tuple(x.shape)}")
        k, s, p = conv
        n, h, w, c = x.shape
        kc = c * k * k
        lead = (n * conv_out(h, k, s, p) * conv_out(w, k, s, p),)
    else:
        if x.dim() not in (2, 3, 4):
            raise ValueError(f"quantize_layout: expected (R, k), (S, R, k) "
                             f"or (A, B, R, k), got {tuple(x.shape)}")
        kc = x.shape[-1]
        lead = tuple(x.shape[:-1])
    if kc > K:
        raise ValueError(f"quantize_layout: {kc} columns exceed K = {K}")
    return kc, lead


def _scatter(q: torch.Tensor, K: int, rows: int, exact: bool) -> torch.Tensor:
    """(..., kc) int8 -> (..., Kk) in the kernel layout: column j to j
    (exact) or to (j // rows) * up32(rows) + j % rows (sliced)."""
    kc = q.shape[-1]
    out = q.new_zeros(*q.shape[:-1], _kernel_k(K, rows, exact))
    if exact:
        out[..., :kc] = q
        return out
    full, rem = divmod(kc, rows)
    grid = out.unflatten(-1, (-1, _up32(rows)))
    grid[..., :full, :rows] = q[..., :full * rows].unflatten(-1, (full, rows))
    if rem:
        grid[..., full, :rem] = q[..., full * rows:]
    return out


def quantize_layout_ref(x: torch.Tensor, K: int, *, bits: int = 8,
                        rows: int = 512, adc_bits: int = 9,
                        conv: tuple[int, int, int] | None = None,
                        per_slice: bool = False
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version, in the kernel's order: the amax over the
    covered elements (strided views of ``x``), each element quantized
    once, then gathered and scattered into the layout."""
    kc, _ = _geometry(x, K, conv)
    rows, exact = _branch(K, rows, adc_bits, None)
    q_max = qmax(bits)
    if conv is not None:
        k, s, p = conv
        n, h, w, c = x.shape
        amax = None
        for hs in covered(h, k, s, p):
            for ws in covered(w, k, s, p):
                m = x[:, hs, ws].abs().amax()
                amax = m if amax is None else torch.maximum(amax, m)
        scale = quantize_scale(amax, bits)
    elif per_slice:
        amax = x.abs().amax(dim=(-2, -1))
        scale = quantize_scale(amax, bits)[..., None, None]
    else:
        amax = x.abs().amax()
        scale = quantize_scale(amax, bits)
    q = torch.round(x / scale).clamp_(-q_max - 1, q_max).to(torch.int8)
    if conv is not None:                  # the patches of the int8 image
        if p:
            q = F.pad(q, (0, 0, p, p, p, p))
        q = q.unfold(1, k, s).unfold(2, k, s)     # (N, OH, OW, C, kh, kw)
        q = q.reshape(-1, kc)
    return _scatter(q, K, rows, exact), amax


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("quantize_layout")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.quantize_layout_conv.argtypes = [p, p, p, *[i] * 19, f, p]
    lib.quantize_layout_conv.restype = i
    lib.quantize_layout_strided.argtypes = [p, p, p, *[i] * 14, f, p]
    lib.quantize_layout_strided.restype = i
    return lib


def _offsets_fit(x: torch.Tensor) -> None:
    """The kernel indexes ``x`` in 32 bits: its elements, and the offset
    of its last one, stay below 2^31."""
    last = sum(st * (n - 1) for st, n in zip(x.stride(), x.shape))
    if x.numel() >= 2 ** 31 or last >= 2 ** 31:
        raise ValueError(f"quantize_layout: {tuple(x.shape)} strides "
                         f"{x.stride()} exceed the kernel's 32-bit offsets")


def _launch(x: torch.Tensor, K: int, kc: int, lead: tuple, *, bits: int,
            rows: int, exact: bool, conv, per_slice: bool
            ) -> tuple[torch.Tensor, torch.Tensor]:
    kk = _kernel_k(K, rows, exact)
    out = torch.empty(*lead, kk, dtype=torch.int8, device=x.device)
    slices = x.shape[:-2] if conv is None and per_slice else ()
    amax = torch.empty(slices, dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out.zero_(), amax.zero_()
    _offsets_fit(x)
    lib = _lib()
    layout = (kk, rows, _up32(rows), int(exact), qmax(bits), inv_qmax(bits),
              _build.stream_handle())
    if conv is not None:
        k, s, p = conv
        n, h, w, c = x.shape
        err = lib.quantize_layout_conv(
            x.data_ptr(), out.data_ptr(), amax.data_ptr(), n, h, w, c,
            *x.stride(), k, s, p, conv_out(h, k, s, p), conv_out(w, k, s, p),
            kc, *layout)
    else:
        v = x.reshape((1,) * (4 - x.dim()) + tuple(x.shape)) \
            if x.dim() < 4 else x                  # (A, B, R, k), a view
        a, b, r, _ = v.shape
        if a * b > 65535:
            raise ValueError(f"quantize_layout: {a * b} slices exceed the "
                             "grid's y limit of 65535")
        err = lib.quantize_layout_strided(
            v.data_ptr(), out.data_ptr(), amax.data_ptr(), a, b, r, kc,
            *v.stride(), int(per_slice), *layout)
    _build.check(lib, "quantize_layout", err)
    quantize_layout.launches += 1
    return out, amax


def quantize_layout(x: torch.Tensor, K: int, *, bits: int = 8,
                    rows: int = 512, adc_bits: int = 9,
                    conv: tuple[int, int, int] | None = None,
                    per_slice: bool = False
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """A stage's float32 input -> (int8 operand in the kernel layout of a
    ``crossbar_gemm`` call of contraction length ``K``, f32 amax).

    ``rows`` and ``adc_bits`` pick the branch as ``crossbar_gemm``
    does (``clip_possible``); ``bits`` is the input width.  ``conv=(k,
    stride, pad)`` takes NHWC ``x`` through its patches; otherwise the
    last two dims of ``x`` are the operand's (R, k), any leading ones its
    slices, and ``per_slice=True`` gives each slice its own amax.  CUDA
    tensors run the kernel, CPU tensors the plain version.
    """
    kc, lead = _geometry(x, K, conv)
    rows, exact = _branch(K, rows, adc_bits, None)
    if x.is_cuda:
        return _launch(x, K, kc, lead, bits=bits, rows=rows, exact=exact,
                       conv=conv, per_slice=per_slice)
    return quantize_layout_ref(x, K, bits=bits, rows=rows, adc_bits=adc_bits,
                               conv=conv, per_slice=per_slice)


quantize_layout.launches = 0
