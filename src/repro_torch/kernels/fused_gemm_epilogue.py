"""Fused GEMM + bias + activation (+ residual).

The port of ``repro.kernels.fused_gemm_epilogue`` (the Pallas kernel) and
of its oracle ``repro.kernels.ref.fused_gemm_epilogue_ref``: x (M, K) @
w (K, N) with float32 accumulation, then ``+ b`` (N,), then ReLU, SiLU,
tanh-GELU or none, then ``+ residual`` (M, N), cast to x's type
(float32 or bfloat16).  The activation comes before the residual here,
unlike ``fb_epilogue``.

For a CUDA tensor ``fused_gemm_epilogue`` launches the hand-written
kernel in ``csrc/fused_gemm_epilogue.cu`` and counts it in
``launches.fused_gemm_epilogue`` (``repro_torch.trace``); for a CPU
tensor it computes the plain PyTorch version.  Nothing falls back from
the card to the plain version.

On the H100 the kernel is bound by latency and by how many of the 132
SMs it keeps busy, not by its products (its header says why).  It runs
the products on the tensor cores (3xTF32 for float32, bf16 ``mma``) and
splits K across the blocks of a cluster where its 64x64 output tiles
are few: ``k_splits`` picks the split from the shape alone, and the
partial tiles are summed in a fixed order, so a shape's output is the
same from run to run.  The bias and the residual reach the kernel in
their own type (float32 or bfloat16) and are converted there.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch import trace

from . import _build

ACTS = {"none": 0, "relu": 1, "silu": 2, "gelu": 3}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GELU_C = math.sqrt(2.0 / math.pi)
TILE = 64                # the kernel's output tile is TILE x TILE
SM_COUNT = 132           # H100 SXM
SPLIT_BYTES = 256        # bytes of each row a split share is a multiple of
MAX_SPLITS = 8           # the blocks of a split form one cluster (at most 8)


def k_splits(M: int, N: int, K: int, elem_size: int = 4,
             splits: int | None = None) -> tuple[int, int]:
    """The kernel's K split for an (M, K) @ (K, N) call on elements of
    ``elem_size`` bytes: ``(splits, k_chunk)``, split ``z`` taking K
    elements ``[z * k_chunk, (z + 1) * k_chunk)``.  A function of the
    shape alone, so a shape's output is the same from run to run.

    As many shares as keep the blocks (TILE x TILE output tiles times
    shares) within ``SM_COUNT``, at most ``MAX_SPLITS``, each a multiple
    of ``SPLIT_BYTES`` of every row (two of the kernel's k-tiles: 64
    float32 or 128 bfloat16 values); unsplit where the tiles alone fill
    more than half the SMs.  ``splits`` forces a count (cut to the K
    there is; no share is empty).
    """
    unit = SPLIT_BYTES // elem_size
    tiles = -(-M // TILE) * -(-N // TILE)
    units = -(-K // unit)
    if splits is None:
        splits = min(SM_COUNT // tiles, MAX_SPLITS) if tiles else 1
    splits = max(1, min(splits, units))
    per = -(-units // splits) if units else 0
    return (-(-units // per) if per else 1), per * unit


def gelu_tanh(y: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default (tanh) form, in its order."""
    return y * (0.5 * (1.0 + torch.tanh(_GELU_C * (y + 0.044715 * (y * y * y)))))


def fused_gemm_epilogue_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                            *, act: str = "silu",
                            residual: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """The plain composition: f32 product, bias, activation, residual,
    cast to x's type."""
    y = x.float() @ w.float() + b.float()
    if act == "relu":
        y = torch.relu(y)
    elif act == "silu":
        y = y * torch.sigmoid(y)
    elif act == "gelu":
        y = gelu_tanh(y)
    elif act != "none":
        raise ValueError(act)
    if residual is not None:
        y = y + residual.float()
    return y.to(x.dtype)


def _check(x, w, b, residual, act) -> None:
    if act not in ACTS:
        raise ValueError(f"fused_gemm_epilogue: act {act!r} not in "
                         f"{tuple(ACTS)}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0] \
            or tuple(b.shape) != (w.shape[1],):
        raise ValueError(f"fused_gemm_epilogue: shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)} do not "
                         "fit (M, K) @ (K, N) + (N,)")
    if residual is not None and tuple(residual.shape) != (x.shape[0],
                                                          w.shape[1]):
        raise ValueError(f"fused_gemm_epilogue: residual "
                         f"{tuple(residual.shape)} is not (M, N)")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"fused_gemm_epilogue takes float32 or bfloat16 x "
                        f"and w of one type, got {x.dtype}, {w.dtype}")
    if any(t is not None and t.device != x.device for t in (w, b, residual)):
        raise ValueError("fused_gemm_epilogue: operands on different "
                         "devices")


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C entry's argument and result types on a loaded
    ``fused_gemm_epilogue`` library (also a variant build of it)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_gemm_epilogue.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                                        i, i, p]
    lib.fused_gemm_epilogue.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return declare(_build.load("fused_gemm_epilogue"))


def _own_type(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernel reads it: float32 and bfloat16 as they are,
    any other float type as float32 (the JAX kernel reads float32)."""
    return (t if t.dtype in _DTYPES else t.float()).contiguous()


def _launch(x, w, b, residual, act: str,
            splits: int | None = None) -> torch.Tensor:
    """Launch the kernel; ``splits`` forces the K split (``k_splits``)."""
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("fused_gemm_epilogue: the CUDA kernel takes "
                         "contiguous x and w")
    M, K = x.shape
    N = w.shape[1]
    out = torch.empty(M, N, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    s, k_chunk = k_splits(M, N, K, x.element_size(), splits)
    b = _own_type(b)
    r = None if residual is None else _own_type(residual)
    lib = _lib()
    err = lib.fused_gemm_epilogue(
        x.data_ptr(), w.data_ptr(), b.data_ptr(),
        None if r is None else r.data_ptr(), out.data_ptr(), M, N, K,
        ACTS[act], _DTYPES[x.dtype], _DTYPES[b.dtype],
        0 if r is None else _DTYPES[r.dtype], s, k_chunk,
        _build.stream_handle())
    _build.check(lib, "fused_gemm_epilogue", err)
    trace.count("launches.fused_gemm_epilogue")
    return out


def fused_gemm_epilogue(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        residual: torch.Tensor | None = None, *,
                        act: str = "silu") -> torch.Tensor:
    """x (M, K) @ w (K, N) + b (N,) -> act -> (+ residual (M, N)).

    CUDA tensors run the kernel, CPU tensors the plain version.
    """
    _check(x, w, b, residual, act)
    if x.is_cuda:
        return _launch(x, w, b, residual, act)
    return fused_gemm_epilogue_ref(x, w, b, act=act, residual=residual)
