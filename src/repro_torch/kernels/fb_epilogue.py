"""Fused functional-block epilogue: int32 crossbar output -> f32 FB chain.

The port of ``repro.kernels.fb_epilogue`` (the Pallas kernel) and of its
oracle ``repro.kernels.ref.fb_epilogue_ref``.  The chain, in the
canonical FB order::

    fma(y, scale, bias) -> + residual -> [* post_scale] -> ReLU | GELU
        -> layer norm -> max/avg pool window | seq-mean  OR  softmax

A leading slice axis runs in the same launch: y (S, M, N) with a
(S, 1, 1) scale applies the chain to each slice with its own scale, what
``jax.vmap`` over the Pallas kernel computes for attention's
per-(batch, head) scores and context.  With ``heads`` the slices (S = B *
heads, slice b * heads + h) are stored with the heads merged, (B, M,
heads * N): the reference's ``merge_heads`` after the context stage
(``src/repro/program/execute.py:135``), done by the stores.  A ``bias``
of None adds nothing (the dynamic stages' zero bias): ``fma(y, scale,
+0)`` rounds as ``y * scale``.

With ``tap=True`` (a layer norm, no pool and no ``heads``) the call
also returns the chain's value before the layer norm, the residual sum
of a pre-norm block, stored in the same pass beside the normalized row
(``program.compile.CrossbarProgram.taps``); calls without a tap launch
the kernels they launched before it existed.

With ``partials=True`` the call also returns, last, the partial maxima
of ``|out|`` it left for the next stage's ``quantize_layout``: a float32
vector whose maximum is ``max |out|`` (one a block of the kernel, at
most ``fb_epilogue_max_parts()``; one on the CPU), or None where the
chain pools or takes a sequence mean (those kernels leave none).
``quantize_layout`` then reduces them in place of its own pass over
``out``: a maximum is exact in any order, so its amax is the same.

For a CUDA tensor ``fb_epilogue`` launches the hand-written kernel in
``csrc/fb_epilogue.cu`` (its header says what bounds it on the H100) and
counts it in ``launches.fb_epilogue`` (``repro_torch.trace``); for a CPU
tensor it computes the plain PyTorch version ``fb_epilogue_ref``.
Nothing falls back from the card to the plain version.

**Numerics.** Jitted XLA contracts the dequant ``y*scale + bias`` into
one fused multiply-add; the kernel calls ``__fmaf_rn`` and the plain
version computes it in float64 and rounds once to float32, which is the
same single rounding.  ``gelu``, ``layer_norm_rows`` and
``softmax_rows`` are the JAX package's formulas, operation for
operation; their transcendentals and sums differ from XLA's by ulps, so
those modes are held to a tolerance, not bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch import trace

from . import _build

_GELU_C = 0.7978845608028654          # sqrt(2/pi)
LN_EPS = 1e-5
_MAX_SMEM = 232448
_ACTS = {"none": 0, "relu": 1, "gelu": 2}
_POOLS = {"none": 0, "max": 1, "avg": 2, "seqmean": 3}
_NORMS = ("none", "layer")


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Tanh-approximated GELU, the JAX package's formula in its order."""
    return 0.5 * x * (1.0 + torch.tanh(_GELU_C * (x + 0.044715 * x * x * x)))


def layer_norm_rows(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    eps: float = LN_EPS) -> torch.Tensor:
    """Per-row layer norm over the last axis, then scale and shift."""
    m = x.mean(dim=-1, keepdim=True)
    d = x - m
    v = (d * d).mean(dim=-1, keepdim=True)
    return d / torch.sqrt(v + eps) * gamma + beta


def softmax_rows(x: torch.Tensor) -> torch.Tensor:
    """Max-subtracted per-row softmax (paper Eq. 1's stabilization)."""
    m = x.amax(dim=-1, keepdim=True)
    e = torch.exp(x - m)
    return e / e.sum(dim=-1, keepdim=True)


def _check_modes(y: torch.Tensor, *, act, pool, window, img_hw, softmax,
                 norm, gamma, beta, heads, tap) -> None:
    M, N = y.shape[-2:]
    if tap and not (norm == "layer" and pool == "none" and not heads):
        raise ValueError("fb_epilogue: a tap stores the row before its "
                         "layer norm; it needs one, and no pool or heads "
                         f"(got norm {norm!r}, pool {pool!r}, heads "
                         f"{heads})")
    if norm == "layer" and pool in ("max", "avg"):
        raise ValueError(f"fb_epilogue: a layer norm does not meet a "
                         f"{pool} pool in one chain")
    if heads and not (heads > 0 and y.dim() == 3 and pool == "none"
                      and y.shape[0] % heads == 0):
        raise ValueError(f"fb_epilogue: heads={heads} merges the slices of "
                         f"a (S, M, N) y, S a multiple of it, without a "
                         f"pool; got {tuple(y.shape)} pool {pool!r}")
    if act not in _ACTS:
        raise ValueError(f"fb_epilogue: act {act!r} not in {tuple(_ACTS)}")
    if pool not in _POOLS:
        raise ValueError(f"fb_epilogue: pool {pool!r} not in "
                         f"{tuple(_POOLS)}")
    if norm not in _NORMS:
        raise ValueError(f"fb_epilogue: norm {norm!r} not in {_NORMS}")
    if norm == "layer" and (gamma is None or beta is None
                            or gamma.shape != (N,) or beta.shape != (N,)):
        raise ValueError("fb_epilogue: norm='layer' needs gamma and beta "
                         f"of shape ({N},)")
    if pool != "none" and softmax:
        raise ValueError("fb_epilogue: pool and softmax FBs never chain "
                         "directly")
    if pool == "seqmean" and not (window >= 1 and M % window == 0):
        raise ValueError(f"fb_epilogue: seqmean window {window} does not "
                         f"divide {M} rows")
    if pool in ("max", "avg") and not (
            window > 1 and img_hw % window == 0
            and M % (img_hw * img_hw) == 0):
        raise ValueError(f"fb_epilogue: {pool} pool window {window} over "
                         f"{img_hw}x{img_hw} images does not tile {M} rows")


# ---------------------------------------------------------------------------
# plain version (the CPU path, and what the kernel is held against)
# ---------------------------------------------------------------------------

def avg_windows(x6: torch.Tensor) -> torch.Tensor:
    """(B, OH, k, OW, k, C) -> (B, OH, OW, C): each k x k window summed in
    row-major order, then multiplied by ``f32(1 / k^2)``: the kernel's
    order on every device (a ``mean`` reduction's order depends on the
    device)."""
    k = x6.shape[2]
    acc = torch.zeros_like(x6[:, :, 0, :, 0])
    for a in range(k):
        for b in range(k):
            acc = acc + x6[:, :, a, :, b]
    return acc * float(np.float32(1.0) / np.float32(k * k))


def dequant(y: torch.Tensor, scale: torch.Tensor,
            bias: torch.Tensor | None) -> torch.Tensor:
    """``fma(float32(y), scale, bias)`` with one rounding, via float64
    (the product of two float32 values is exact there); no bias: the
    product rounded once."""
    out = y.float().double() * scale.double()
    return (out if bias is None else out + bias.double()).float()


def merge_heads(ctx: torch.Tensor, heads: int) -> torch.Tensor:
    """(B * heads, T, hd) attention context -> (B, T, heads * hd): slice
    b * heads + h's row t to ``[b, t, h * hd:(h + 1) * hd]``."""
    bh, T, hd = ctx.shape
    B = bh // heads
    return (ctx.reshape(B, heads, T, hd).permute(0, 2, 1, 3)
            .reshape(B, T, heads * hd))


def _outputs(out, tapped, parts, *, tap: bool, partials: bool):
    """``out``, then the tap and the partial maxima where asked."""
    extra = (tapped,) * tap + (parts,) * partials
    return (out, *extra) if extra else out


def split_outputs(got, *, tap: bool = False, partials: bool = False
                  ) -> tuple:
    """An ``fb_epilogue`` result of a call with these ``tap`` and
    ``partials`` -> ``(out, tap or None, partial maxima or None)``."""
    got = tuple(got) if tap or partials else (got,)
    return (got[0], got[1] if tap else None, got[-1] if partials else None)


def fb_epilogue_ref(y: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor | None,
                    residual: torch.Tensor | None = None, *,
                    act: str = "none", pool: str = "none", window: int = 0,
                    img_hw: int = 0, softmax: bool = False,
                    norm: str = "none", gamma: torch.Tensor | None = None,
                    beta: torch.Tensor | None = None,
                    post_scale: float = 0.0, heads: int = 0,
                    tap: bool = False, partials: bool = False):
    """The plain PyTorch composition the kernel must equal.

    Average pooling sums each window in row-major order and multiplies
    by ``f32(1 / window^2)``, the order the kernel uses
    (``avg_windows``).  A 3-D ``y`` (S, M, N) takes a (S, 1, 1)
    ``scale``; no pool window or sequence crosses a slice, so the rest
    of the chain runs on the (S*M, N) rows.  With ``tap`` it returns
    ``(out, tap)``, ``tap`` the rows before the layer norm, shaped as
    ``y``; with ``partials`` one partial maximum last, ``max |out|``
    (None where the chain pools, as the kernel's).
    """
    N = y.shape[-1]
    out = dequant(y, scale.reshape(-1, 1, 1) if y.dim() == 3
                  else scale.reshape(1, 1), bias).reshape(-1, N)
    M = out.shape[0]
    if residual is not None:
        out = out + residual.reshape(-1, N)
    if post_scale:
        out = out * post_scale
    if act == "relu":
        out = torch.relu(out)
    elif act == "gelu":
        out = gelu(out)
    tapped = out.reshape(y.shape) if tap else None
    if norm == "layer":
        out = layer_norm_rows(out, gamma, beta)
    if pool == "seqmean":
        out = out.reshape(M // window, window, N).mean(dim=1)
    elif pool != "none":
        oh = img_hw // window
        x6 = out.reshape(M // (img_hw * img_hw), oh, window, oh, window, N)
        out = x6.amax(dim=(2, 4)) if pool == "max" else avg_windows(x6)
        out = out.reshape(-1, N)
    if softmax:
        out = softmax_rows(out)
    out = out.reshape(*y.shape[:-2], -1, N)
    if heads:
        out = merge_heads(out, heads)
    parts = None
    if partials and pool == "none" and out.numel():
        parts = out.abs().amax().reshape(1)
    return _outputs(out, tapped, parts, tap=tap, partials=partials)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fb_epilogue")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fb_epilogue.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, f, i, i,
                                i, i, i, i, p, ctypes.POINTER(i), p]
    lib.fb_epilogue.restype = i
    lib.fb_epilogue_rows_smem.argtypes = [i, i]
    lib.fb_epilogue_rows_smem.restype = i
    lib.fb_epilogue_max_parts.argtypes = []
    lib.fb_epilogue_max_parts.restype = i
    return lib


def _operand(t: torch.Tensor | None, name: str, dtype: torch.dtype,
             shape: tuple, device: torch.device) -> int | None:
    if t is None:
        return None
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device \
            or not t.is_contiguous():
        raise ValueError(f"fb_epilogue: {name} must be a contiguous "
                         f"{dtype} tensor of shape {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return t.data_ptr()


def _launch(y, scale, bias, residual, *, act, pool, window, img_hw, softmax,
            norm, gamma, beta, post_scale, heads, tap, partials):
    M, N = y.shape[-2:]
    S = y.shape[0] if y.dim() == 3 else 1
    lead = y.shape[:-2]
    dev = y.device
    has_norm = norm == "layer"
    if has_norm and pool in ("max", "avg"):
        raise ValueError("fb_epilogue: the kernel does not chain a layer "
                         "norm into a spatial pool (no compiled program "
                         "has one)")
    ptrs = [_operand(y, "y", torch.int32, (*lead, M, N), dev),
            _operand(scale, "scale", torch.float32,
                     (S, 1, 1) if lead else (1, 1), dev),
            _operand(bias, "bias", torch.float32, (N,), dev),
            _operand(residual, "residual", torch.float32, (*lead, M, N),
                     dev),
            _operand(gamma if has_norm else None, "gamma", torch.float32,
                     (N,), dev),
            _operand(beta if has_norm else None, "beta", torch.float32,
                     (N,), dev)]
    if pool == "seqmean":
        out_rows = M // window
    elif pool != "none":
        out_rows = (M // (img_hw * img_hw)) * (img_hw // window) ** 2
    else:
        out_rows = M
    shape = ((S // heads, out_rows, heads * N) if heads
             else (*lead, out_rows, N))
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    tapped = torch.empty_like(y, dtype=torch.float32) if tap else None
    if out.numel() == 0:
        return _outputs(out, tapped, None, tap=tap, partials=partials)
    lib = _lib()
    if lib.fb_epilogue_rows_smem(N, int(pool == "seqmean")) > _MAX_SMEM:
        raise ValueError(f"fb_epilogue: a {N}-column row does not fit a "
                         "block's shared memory")
    part = (torch.empty(lib.fb_epilogue_max_parts(), dtype=torch.float32,
                        device=dev) if partials else None)
    n_parts = ctypes.c_int(0)
    err = lib.fb_epilogue(*ptrs, out.data_ptr(),
                          None if tapped is None else tapped.data_ptr(),
                          S * M, N, M, _ACTS[act],
                          float(post_scale), int(has_norm), _POOLS[pool],
                          int(window), int(img_hw), int(softmax), int(heads),
                          None if part is None else part.data_ptr(),
                          ctypes.byref(n_parts), _build.stream_handle())
    _build.check(lib, "fb_epilogue", err)
    trace.count("launches.fb_epilogue")
    parts = part[:n_parts.value] if n_parts.value else None
    return _outputs(out, tapped, parts, tap=tap, partials=partials)


def fb_epilogue(y: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor | None,
                residual: torch.Tensor | None = None, *, act: str = "none",
                pool: str = "none", window: int = 0, img_hw: int = 0,
                softmax: bool = False, norm: str = "none",
                gamma: torch.Tensor | None = None,
                beta: torch.Tensor | None = None,
                post_scale: float = 0.0, heads: int = 0, tap: bool = False,
                partials: bool = False):
    """y (M, N) int32 crossbar output -> fused FB chain -> f32.

    ``scale`` is the (1, 1) f32 requant factor, ``bias`` (N,) or None; a
    3-D ``y`` (S, M, N) takes a (S, 1, 1) ``scale``, one per slice, and
    returns (S, out_rows, N) with every mode applied per slice, or with
    ``heads`` (no pool) (S / heads, M, heads * N), the heads merged.  ``pool``
    max/avg reduce ``window x window`` blocks of each image's
    ``img_hw x img_hw`` rows (M = B * img_hw^2, output
    (B * (img_hw // window)^2, N)); ``seqmean`` averages each sequence's
    ``window`` rows (output (M // window, N)).  ``norm="layer"`` applies
    ``layer_norm_rows`` with ``gamma``/``beta`` (N,); ``softmax=True``
    normalizes each row.  ``tap=True`` returns ``(out, tap)``: ``tap``
    (shaped as ``y``, f32) the rows before the layer norm, stored by the
    same launch.  ``partials=True`` appends the partial maxima of
    ``|out|`` (module docstring), or None.  CUDA tensors run the kernel,
    CPU tensors the plain version.
    """
    if y.dim() not in (2, 3):
        raise ValueError(f"fb_epilogue: y must be (M, N) or (S, M, N), got "
                         f"{tuple(y.shape)}")
    _check_modes(y, act=act, pool=pool, window=window, img_hw=img_hw,
                 softmax=softmax, norm=norm, gamma=gamma, beta=beta,
                 heads=heads, tap=tap)
    kw = dict(act=act, pool=pool, window=window, img_hw=img_hw,
              softmax=softmax, norm=norm, gamma=gamma, beta=beta,
              post_scale=post_scale, heads=heads, tap=tap,
              partials=partials)
    if y.is_cuda:
        return _launch(y, scale, bias, residual, **kw)
    return fb_epilogue_ref(y, scale, bias, residual, **kw)
