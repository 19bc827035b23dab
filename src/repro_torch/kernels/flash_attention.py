"""Flash attention: online-softmax attention (paper Eq. 1).

The port of ``repro.kernels.flash_attention`` (the Pallas kernel) and of
its oracle ``repro.kernels.ref.flash_attention_ref``.  q/k/v are
(B, S, H, hd), float32 or bfloat16; the output has q's shape and type.
``sm_scale = 1/sqrt(hd)`` scales the scores; ``causal`` and a sliding
``window`` mask keys.  The shapes the JAX wrapper accepts are the shapes
this one accepts: ``S`` must be a multiple of ``min(block, S)`` for both
blocks, and ``hd`` at most 128 here.  GQA kv heads are expanded by
``ops.attention``, not here.

For a CUDA tensor ``flash_attention`` launches the hand-written kernel in
``csrc/flash_attention.cu`` (its header says what bounds it on the H100)
and adds one to ``flash_attention.launches``; for a CPU tensor it
computes the plain PyTorch version ``flash_attention_ref``.  Nothing
falls back from the card to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q/k/v (B, S, H, hd) -> (B, S, H, hd), float32 accumulation.

    The plain composition: masked scores, a max floored at -1e30, exp,
    the weighted sum and a denominator floored at 1e-30.
    """
    sq, hd = q.shape[1], q.shape[3]
    sk = k.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) / math.sqrt(hd)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    scores = scores.masked_fill(~mask, -math.inf)
    m = scores.amax(-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(scores - m)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    denom = p.sum(-1).clamp_min(1e-30)                     # (B, H, Sq)
    return (out / denom.transpose(1, 2)[..., None]).to(q.dtype)


def _check(q, k, v, block_q: int, block_k: int) -> None:
    if q.dim() != 4:
        raise ValueError(f"flash_attention: q must be (B, S, H, hd), got "
                         f"{tuple(q.shape)}")
    b, sq, h, hd = q.shape
    sk = k.shape[1] if k.dim() == 4 else -1
    if tuple(k.shape) != (b, sk, h, hd) or tuple(v.shape) != (b, sk, h, hd):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be (B, Sk, H, hd) with "
                         f"q's B, H, hd {(b, h, hd)}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {hd} > "
                         f"{MAX_HEAD_DIM}")
    bq, bk = min(block_q, sq), min(block_k, sk)
    if bq < 1 or bk < 1 or sq % bq or sk % bk:
        raise ValueError(f"flash_attention: sequence lengths ({sq}, {sk}) "
                         f"are not multiples of the blocks ({bq}, {bk})")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q/k/v "
                        f"of one type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention.argtypes = [p, p, p, p, i, i, i, i, i, f, i, i, i, p]
    lib.flash_attention.restype = i
    return lib


def _launch(q, k, v, *, causal: bool, window: int) -> torch.Tensor:
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: the CUDA kernel takes contiguous "
                         "q, k, v")
    b, sq, h, hd = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _lib()
    err = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
        k.shape[1], h, hd, 1.0 / math.sqrt(hd), int(causal), int(window),
        _DTYPES[q.dtype], _build.stream_handle())
    _build.check(lib, "flash_attention", err)
    flash_attention.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """q/k/v (B, S, H, hd) -> (B, S, H, hd).  GQA: expand kv first.

    ``block_q``/``block_k`` are the JAX kernel's blocks: they decide which
    sequence lengths are accepted (``ValueError`` otherwise), not how
    the CUDA kernel tiles.  CUDA tensors run the kernel, CPU tensors the
    plain version.
    """
    _check(q, k, v, block_q, block_k)
    if q.is_cuda:
        return _launch(q, k, v, causal=causal, window=window)
    return flash_attention_ref(q, k, v, causal=causal, window=window)


flash_attention.launches = 0
