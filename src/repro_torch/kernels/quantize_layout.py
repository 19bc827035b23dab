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

With ``w_amax=`` and ``weight_bits`` it also returns ``requant``, the
stage's requant factor, float32:

* a weight-mounted stage passes its mount's amax, a one-element tensor,
  and gets (1, 1): bit for bit ``core.crossbar.dequant_scale(amax, w_amax,
  bits, weight_bits)``, the form jitted XLA makes of the static stage's
  ``xs * quantize_scale(w_amax)`` (``src/repro/program/execute.py:170-171``);
* a dynamic (attention) stage's left operand, ``per_slice=True``, passes
  the right operand's per-slice amax (one a slice) and gets (S, 1, 1): the
  plain product ``quantize_scale(amax, bits) * quantize_scale(w_amax,
  weight_bits)`` slice by slice, which XLA does not reassociate under
  ``jax.vmap`` (``:127``; ``requant_plain``).

A dynamic stage makes two calls: its right operand first (the K-major
view of K or Vᵀ at ``bits=weight_bits``, per slice: the output is
``crossbar_gemm``'s ``wt``, the function ``jax.vmap(plane_pack)`` then
``kernel_layout`` computes), then its left operand with that call's amax
as ``w_amax``.  The second call's first kernel reads ``w_amax`` only
after the first call's last kernel has finished (no programmatic
dependent launch crosses calls).

For a CUDA tensor the wrapper launches ``csrc/quantize_layout.cu`` and
adds one to ``quantize_layout.launches`` (one a call, whatever the path)
and its device kernels to the counter ``trace.count(DEVICE_KERNELS)``;
for a CPU tensor it computes the plain version, ``quantize_layout_ref``.
Nothing falls back from the card to the plain version.  ``plan`` picks
the kernel's path from the call's geometry, and ``device_kernels`` says
how many device kernels a call launches:

* one launch of thread-block clusters where the covered input (a slice's,
  per slice) holds at most ``ONE_LAUNCH_MAX`` elements, a 1x1 conv aside
  (the threshold, and the 1x1 exception, chosen on the H100: ``PERF.md``);
* otherwise an amax pass that leaves partial maxima in scratch, then
  either a pass that quantizes straight into the layout (no repeated
  taps: 1x1 convs, the views), or, for a conv with k > 1, a pass that
  quantizes the covered input into an int8 image and a pass that gathers
  the patch rows from it: 2 or 3 kernels, the later ones programmatic
  dependent launches.

No path memsets or reads a value back to the host; scratch comes from
torch's allocator, so a CUDA graph's pool holds it.

Where it can go wrong, and what holds it (``tests/
test_torch_quantize_layout.py`` against the JAX package's jitted chain,
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 29 on the card,
each path forced):

1. pixels that no patch reads: a 1x1 stride-2 conv's patch matrix holds
   only even rows and columns, so the amax (and the int8 image) walks the
   covered pixels (``covered``), not the whole input (the zero pad of a
   conv cannot raise a maximum of |x| and is skipped);
2. the division: ``x / scale`` is a correctly rounded division, not
   ``x * (1 / scale)``, and ``round`` goes half to even; the kernel's
   arithmetic moves between passes but is never rewritten;
3. graph capture: no host sync, no ``.item()``, outputs and scratch
   allocated by torch, the launch on the current stream; every block
   writes its partial-maximum slot, so a replay never reads a stale one;
4. the sliced layout: column k goes to ``(k // rows) * up32(rows) +
   k % rows``, the (C, kh, kw) order kept (it decides which columns an
   ADC read sums);
5. ``input_bits`` 4 to 8: ``qmax`` comes from ``bits``;
6. limits: offsets into ``x`` in 32 bits (``_offsets_fit``), at most
   65535 slices, a conv window of at most 64 KB.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import trace

from . import _build
from .crossbar_gemm import _branch, _kernel_k, _up32

DEVICE_KERNELS = "device_kernels.quantize_layout"   # counter (``plan``)

AMAX_FLOOR = 1e-8
# the one-launch path: covered elements (a slice's, per slice) at most,
# chosen on the H100 (PERF.md); a 1x1 conv (rows of strided pixels) never
# takes it: it lost to the multi-pass path at every size measured
ONE_LAUNCH_MAX = 1 << 16
CLUSTER = 8                  # blocks a cluster (the portable size)
MAX_ONE_BLOCKS = 128         # blocks of a one-launch call, one amax
WORDS_PER_BLOCK = 512        # output words (16 bytes) a block, per slice
SLICE_PER_BLOCK = 8192       # a slice's covered elements a block, per slice
AMAX_PER_BLOCK = 2048        # covered elements a block reduces (one
                             # launch; more make a cluster of more blocks)
PART_ELEMS = 4096            # covered elements a partial maximum
MAX_PARTS = 1024             # partial maxima a call (the kernel's cap a
                             # slice)


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


def requant_c(bits: int, weight_bits: int) -> float:
    """``f32(f32(1/qx) * f32(1/qw))``: the constant XLA folds the two
    scales' ``/ qmax`` into."""
    return float(np.float32(inv_qmax(bits)) * np.float32(inv_qmax(weight_bits)))


def requant_plain(amax: torch.Tensor, w_amax: torch.Tensor, bits: int = 8,
                  weight_bits: int = 8) -> torch.Tensor:
    """A dynamic stage's per-slice requant factor, (S, 1, 1): the plain
    product ``quantize_scale(amax, bits) * quantize_scale(w_amax,
    weight_bits)`` of each slice's two scales."""
    return (quantize_scale(amax, bits)
            * quantize_scale(w_amax.reshape(amax.shape), weight_bits)
            ).reshape(-1, 1, 1)


def requant_factor(amax: torch.Tensor, w_amax: torch.Tensor, bits: int = 8,
                   weight_bits: int = 8) -> torch.Tensor:
    """A static stage's requant factor, (1, 1): ``(max(amax, 1e-8) *
    max(w_amax, 1e-8)) * requant_c``, ``core.crossbar.dequant_scale``'s
    expression (the kernels package cannot import ``core``)."""
    return ((torch.clamp_min(amax, AMAX_FLOOR)
             * torch.clamp_min(w_amax, AMAX_FLOOR))
            * requant_c(bits, weight_bits)).reshape(1, 1)


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
                        per_slice: bool = False,
                        w_amax: torch.Tensor | None = None,
                        weight_bits: int = 8) -> tuple[torch.Tensor, ...]:
    """The plain version, in the kernel's order: the amax over the
    covered elements (strided views of ``x``), each element quantized
    once (a conv's input as an int8 image), then gathered and scattered
    into the layout; with ``w_amax`` the requant factor beside them."""
    kc, _ = _geometry(x, K, conv)
    _check_requant(x, conv, w_amax, per_slice)
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
    out = (_scatter(q, K, rows, exact), amax)
    if w_amax is None:
        return out
    factor = requant_plain if per_slice else requant_factor
    return (*out, factor(amax, w_amax, bits, weight_bits))


def _slices(x: torch.Tensor, conv, per_slice: bool) -> int:
    """Amaxes a call writes: one a slice, or one."""
    return int(np.prod(x.shape[:-2])) if per_slice and conv is None else 1


def _check_requant(x: torch.Tensor, conv, w_amax: torch.Tensor | None,
                   per_slice: bool) -> None:
    """``w_amax``: one float32 a slice of ``x`` (per slice), else one."""
    if w_amax is None:
        return
    if per_slice and conv is not None:
        raise ValueError("quantize_layout: a per-slice requant factor "
                         "takes a strided view, not a conv")
    n = _slices(x, conv, per_slice)
    if w_amax.numel() != n or w_amax.dtype != torch.float32:
        raise ValueError(f"quantize_layout: w_amax is {n} float32 (one a "
                         f"slice), got {tuple(w_amax.shape)} {w_amax.dtype}")


class Plan(NamedTuple):
    """How the kernel runs a call (``plan``)."""
    one_launch: bool   # one launch of thread-block clusters
    kernels: int       # device kernels the call launches
    blocks: int        # clusters (one launch, one amax) or partial maxima
                       # a slice (multi-pass)
    cluster: int       # blocks a cluster (one launch)
    image: bool        # an int8 image and a column table as scratch


def _covered_elems(x: torch.Tensor,
                   conv: tuple[int, int, int] | None) -> int:
    """Elements the amax reads: a conv's covered pixels, or all of x."""
    if conv is None:
        return x.numel()
    n, h, w, c = x.shape

    def count(size):
        return sum(len(range(size)[sl]) for sl in covered(size, *conv))
    return n * count(h) * count(w) * c


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def plan(x: torch.Tensor, K: int, *, rows: int = 512, adc_bits: int = 9,
         conv: tuple[int, int, int] | None = None,
         per_slice: bool = False) -> Plan:
    """The kernel's path for a call, from its geometry alone (``x``'s
    shape).  Where the covered input (a slice's, per slice) holds at most
    ``ONE_LAUNCH_MAX`` elements and the call is no 1x1 conv, one launch:
    per slice, one cluster a
    slice of as many blocks as ``SLICE_PER_BLOCK`` elements and
    ``WORDS_PER_BLOCK`` output words a block need; otherwise
    ``MAX_ONE_BLOCKS`` blocks in clusters of as many as ``AMAX_PER_BLOCK``
    covered elements a block need (at most ``CLUSTER``; a cluster of one
    needs no barrier).  Otherwise ``PART_ELEMS`` covered elements a
    partial maximum, then one pass (rows) or two (a conv with k > 1: the
    image, the gather)."""
    _, lead = _geometry(x, K, conv)
    rows, exact = _branch(K, rows, adc_bits, None)
    kk = _kernel_k(K, rows, exact)
    slices = _slices(x, conv, per_slice)
    elems = _covered_elems(x, conv) // slices
    words = int(np.prod(lead)) * (kk // 16) // slices
    image = conv is not None and conv[0] > 1
    if elems <= ONE_LAUNCH_MAX and (conv is None or conv[0] > 1):
        if per_slice:
            need = max(-(-elems // SLICE_PER_BLOCK),
                       -(-words // WORDS_PER_BLOCK))
            return Plan(True, 1, slices, min(CLUSTER, _pow2_at_least(need)),
                        False)
        cluster = min(CLUSTER, _pow2_at_least(-(-elems // AMAX_PER_BLOCK)))
        return Plan(True, 1, MAX_ONE_BLOCKS // cluster, cluster, False)
    parts = max(1, min(-(-elems // PART_ELEMS), MAX_PARTS // slices))
    return Plan(False, 3 if image else 2, parts, 1, image)


def device_kernels(x: torch.Tensor, K: int, **kw) -> int:
    """Device kernels one ``quantize_layout(x, K, **kw)`` call launches on
    the card (``plan``; none for an empty operand).  ``kw`` as
    ``quantize_layout`` takes them; ``bits``, ``w_amax`` and
    ``weight_bits`` do not change the count."""
    geo = {k: v for k, v in kw.items()
           if k in ("rows", "adc_bits", "conv", "per_slice")}
    _, lead = _geometry(x, K, geo.get("conv"))
    if int(np.prod(lead)) == 0:
        return 0
    return plan(x, K, **geo).kernels


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C entries' parameters (``csrc/quantize_layout.cu``'s extern "C")
SIGNATURES = {
    "quantize_layout_conv": [_P, _P, _P, _P, _P, _F, _P, _P, _P, *[_I] * 19,
                             _F, _I, _I, _I, _P],
    "quantize_layout_strided": [_P, _P, _P, _P, _P, _F, _P, *[_I] * 14, _F,
                                _I, _I, _I, _P],
}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("quantize_layout")
    for name, argtypes in SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = _I
    return lib


def _offsets_fit(x: torch.Tensor) -> None:
    """The kernel indexes ``x`` in 32 bits: its elements, and the offset
    of its last one, stay below 2^31."""
    last = sum(st * (n - 1) for st, n in zip(x.stride(), x.shape))
    if x.numel() >= 2 ** 31 or last >= 2 ** 31:
        raise ValueError(f"quantize_layout: {tuple(x.shape)} strides "
                         f"{x.stride()} exceed the kernel's 32-bit offsets")


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _launch(x: torch.Tensor, K: int, kc: int, lead: tuple, *, bits: int,
            rows: int, adc_bits: int, exact: bool, conv, per_slice: bool,
            w_amax: torch.Tensor | None, weight_bits: int
            ) -> tuple[torch.Tensor, ...]:
    kk = _kernel_k(K, rows, exact)
    out = torch.empty(*lead, kk, dtype=torch.int8, device=x.device)
    slices = x.shape[:-2] if conv is None and per_slice else ()
    amax = torch.empty(slices, dtype=torch.float32, device=x.device)
    requant = None
    if w_amax is not None:
        if w_amax.device != x.device or not w_amax.is_contiguous():
            raise ValueError(f"quantize_layout: w_amax must be contiguous "
                             f"on {x.device}, got {w_amax.device}")
        shape = (_slices(x, conv, True), 1, 1) if per_slice else (1, 1)
        requant = torch.empty(shape, dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        out.zero_(), amax.zero_()
        factor = requant_plain if per_slice else requant_factor
        return (out, amax) if requant is None else (
            out, amax, factor(amax, w_amax, bits, weight_bits))
    _offsets_fit(x)
    n_slices = int(np.prod(x.shape[:-2])) if conv is None else 1
    if n_slices > 65535:
        raise ValueError(f"quantize_layout: {n_slices} slices exceed the "
                         "grid's y limit of 65535")
    pl = plan(x, K, rows=rows, adc_bits=adc_bits, conv=conv,
              per_slice=per_slice)
    partials = image = table = None
    if not pl.one_launch:
        partials = torch.empty(pl.blocks * (n_slices if per_slice else 1),
                               dtype=torch.float32, device=x.device)
    if pl.image:
        image = torch.empty(x.numel(), dtype=torch.int8, device=x.device)
        table = torch.empty(kk, dtype=torch.int16, device=x.device)
    lib = _lib()
    req_c = inv_qmax(weight_bits) if per_slice else requant_c(bits,
                                                              weight_bits)
    head = (x.data_ptr(), out.data_ptr(), amax.data_ptr(), _ptr(requant),
            _ptr(w_amax), req_c, _ptr(partials))
    layout = (kk, rows, _up32(rows), int(exact), qmax(bits), inv_qmax(bits),
              int(pl.one_launch), pl.blocks, pl.cluster,
              _build.stream_handle())
    if conv is not None:
        k, s, p = conv
        n, h, w, c = x.shape
        err = lib.quantize_layout_conv(
            *head, _ptr(image), _ptr(table), n, h, w, c, *x.stride(), k, s, p,
            conv_out(h, k, s, p), conv_out(w, k, s, p), kc, *layout)
    else:
        v = x.reshape((1,) * (4 - x.dim()) + tuple(x.shape)) \
            if x.dim() < 4 else x                  # (A, B, R, k), a view
        a, b, r, _ = v.shape
        err = lib.quantize_layout_strided(
            *head, a, b, r, kc, *v.stride(), int(per_slice), *layout)
    _build.check(lib, "quantize_layout", err)
    quantize_layout.launches += 1
    trace.count(DEVICE_KERNELS, pl.kernels)
    return (out, amax) if requant is None else (out, amax, requant)


def quantize_layout(x: torch.Tensor, K: int, *, bits: int = 8,
                    rows: int = 512, adc_bits: int = 9,
                    conv: tuple[int, int, int] | None = None,
                    per_slice: bool = False,
                    w_amax: torch.Tensor | None = None,
                    weight_bits: int = 8) -> tuple[torch.Tensor, ...]:
    """A stage's float32 input -> (int8 operand in the kernel layout of a
    ``crossbar_gemm`` call of contraction length ``K``, f32 amax), and
    with ``w_amax`` the requant factor third: (1, 1), or per slice (S, 1,
    1), the plain product (module docstring).

    ``rows`` and ``adc_bits`` pick the branch as ``crossbar_gemm``
    does (``clip_possible``); ``bits`` is the input width, ``weight_bits``
    the mounted weight's.  ``conv=(k, stride, pad)`` takes NHWC ``x``
    through its patches; otherwise the last two dims of ``x`` are the
    operand's (R, k), any leading ones its slices, and ``per_slice=True``
    gives each slice its own amax (and takes one ``w_amax`` a slice).
    CUDA tensors run the kernel, CPU tensors the plain version.
    """
    kc, lead = _geometry(x, K, conv)
    _check_requant(x, conv, w_amax, per_slice)
    rows, exact = _branch(K, rows, adc_bits, None)
    if x.is_cuda:
        return _launch(x, K, kc, lead, bits=bits, rows=rows,
                       adc_bits=adc_bits, exact=exact, conv=conv,
                       per_slice=per_slice, w_amax=w_amax,
                       weight_bits=weight_bits)
    return quantize_layout_ref(x, K, bits=bits, rows=rows, adc_bits=adc_bits,
                               conv=conv, per_slice=per_slice, w_amax=w_amax,
                               weight_bits=weight_bits)


quantize_layout.launches = 0
