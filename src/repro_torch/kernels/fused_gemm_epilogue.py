"""Fused GEMM + bias + activation (+ residual).

The port of ``repro.kernels.fused_gemm_epilogue`` (the Pallas kernel) and
of its oracle ``repro.kernels.ref.fused_gemm_epilogue_ref``: x (M, K) @
w (K, N) with float32 accumulation, then ``+ b`` (N,), then ReLU, SiLU,
tanh-GELU or none, then ``+ residual`` (M, N), cast to x's type
(float32 or bfloat16).  The activation comes before the residual here,
unlike ``fb_epilogue``.

For a CUDA tensor ``fused_gemm_epilogue`` launches the hand-written
kernel in ``csrc/fused_gemm_epilogue.cu`` (its header says what bounds
it on the H100) and adds one to ``fused_gemm_epilogue.launches``; for a
CPU tensor it computes the plain PyTorch version.  Nothing falls back
from the card to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

ACTS = {"none": 0, "relu": 1, "silu": 2, "gelu": 3}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GELU_C = math.sqrt(2.0 / math.pi)


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


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_gemm_epilogue")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_gemm_epilogue.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.fused_gemm_epilogue.restype = i
    return lib


def _launch(x, w, b, residual, act: str) -> torch.Tensor:
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("fused_gemm_epilogue: the CUDA kernel takes "
                         "contiguous x and w")
    M, K = x.shape
    N = w.shape[1]
    out = torch.empty(M, N, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    # the JAX kernel reads the bias and the residual as float32
    b32 = b.float().contiguous()
    r32 = None if residual is None else residual.float().contiguous()
    lib = _lib()
    err = lib.fused_gemm_epilogue(
        x.data_ptr(), w.data_ptr(), b32.data_ptr(),
        None if r32 is None else r32.data_ptr(), out.data_ptr(), M, N, K,
        ACTS[act], _DTYPES[x.dtype], _build.stream_handle())
    _build.check(lib, "fused_gemm_epilogue", err)
    fused_gemm_epilogue.launches += 1
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


fused_gemm_epilogue.launches = 0
