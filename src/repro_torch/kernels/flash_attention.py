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
and counts it in ``launches.flash_attention`` (``repro_torch.trace``);
for a CPU tensor it computes the plain PyTorch version
``flash_attention_ref``.  Nothing
falls back from the card to the plain version.

Where ``B * H * q_tiles`` blocks would leave SMs idle the kernel splits
each query tile's keys into contiguous shares (``key_splits`` picks the
count from the shape alone, ``key_ranges`` cuts the shares) and merges
the partial (m, l, acc) of the shares in a fixed order.
``flash_attention_split_ref`` is that split's plain version, with the
kernel's merge arithmetic; the CPU tests and ``chip_smoke.py`` use it,
no CUDA path does.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch import trace

from . import _build

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SPLIT_BLOCKS = 2 * 132        # split the keys below two blocks per H100 SM
MAX_SPLITS = 8
_MASKED = -1e30


def query_tile(sq: int) -> int:
    """Query rows a kernel block takes: 16 per warp, up to 4 warps."""
    return 16 * min(4, -(-sq // 16))


def key_tile(hd: int) -> int:
    """Keys a kernel tile holds (``csrc/flash_attention.cu``'s ``BK``)."""
    return 64 if hd <= 64 else 32


def key_splits(b: int, h: int, sq: int, sk: int, hd: int) -> int:
    """How many key shares each query tile is cut into: a function of the
    shape alone, so a shape's output is the same from run to run.  1
    where the ``B * H * q_tiles`` blocks reach ``SPLIT_BLOCKS``; else
    enough shares to reach it, at most one per key tile and
    ``MAX_SPLITS``."""
    blocks = b * h * -(-sq // query_tile(sq))
    if blocks >= SPLIT_BLOCKS or blocks == 0:
        return 1
    return max(1, min(-(-sk // key_tile(hd)), -(-SPLIT_BLOCKS // blocks),
                      MAX_SPLITS))


def key_ranges(sq: int, sk: int, hd: int, *, causal: bool, window: int,
               splits: int) -> list[list[tuple[int, int]]]:
    """Per query tile, the key ranges [lo, hi) of its shares, in merge
    order: the tiles its queries can see (cut as JAX cuts its k-blocks),
    dealt out contiguously to ``min(splits, tiles)`` shares (the
    kernel's ``key_share``)."""
    bq, bk = query_tile(sq), key_tile(hd)
    out = []
    for q0 in range(0, sq, bq):
        q_last = min(q0 + bq, sq) - 1
        hi = min(sk, q_last + 1) if causal else sk
        lo = max(0, q0 - window + 1) // bk * bk if window > 0 else 0
        n = -(-(hi - lo) // bk) if hi > lo else 0
        if n <= 0:
            out.append([(lo, lo)])
            continue
        count = min(splits, n)
        t_lo = lo // bk
        out.append([((t_lo + z * n // count) * bk,
                     min(hi, (t_lo + (z + 1) * n // count) * bk))
                    for z in range(count)])
    return out


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


def flash_attention_split_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: int = 0,
                              splits: int | None = None) -> torch.Tensor:
    """The key split's plain version: q/k/v (B, S, H, hd) -> (B, S, H, hd).

    Per query tile and share of ``key_ranges``: scores ``(q.k)*sm_scale``
    with masked keys at -1e30, ``m = max(-1e30, max s)``, ``p =
    exp(s - m)``, ``l = sum p``, ``acc = p @ v``; then the kernel's merge,
    share by share in order: ``w = exp(m_z - max m)``, ``l += l_z * w``,
    ``acc += acc_z * w``, ``out = acc * (1 / max(l, 1e-30))``.
    ``splits`` defaults to ``key_splits`` of the shape.
    """
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    if splits is None:
        splits = key_splits(b, h, sq, sk, hd)
    sm_scale = 1.0 / math.sqrt(hd)
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))  # (B,H,S,hd)
    out = torch.zeros(b, h, sq, hd, dtype=torch.float32, device=q.device)
    bq = query_tile(sq)
    for qi, shares in enumerate(key_ranges(sq, sk, hd, causal=causal,
                                           window=window, splits=splits)):
        q0, q1 = qi * bq, min((qi + 1) * bq, sq)
        qpos = torch.arange(q0, q1, device=q.device)[:, None]
        parts = []
        for lo, hi in shares:
            s = (qf[:, :, q0:q1] @ kf[:, :, lo:hi].transpose(-1, -2)) \
                * sm_scale
            kpos = torch.arange(lo, hi, device=q.device)[None, :]
            seen = torch.ones(q1 - q0, hi - lo, dtype=torch.bool,
                              device=q.device)
            if causal:
                seen &= kpos <= qpos
            if window > 0:
                seen &= kpos > qpos - window
            s = s.masked_fill(~seen, _MASKED)
            m = s.amax(-1, keepdim=True).clamp_min(_MASKED) if hi > lo \
                else torch.full((b, h, q1 - q0, 1), _MASKED, device=q.device)
            p = torch.exp(s - m)
            parts.append((m, p.sum(-1, keepdim=True), p @ vf[:, :, lo:hi]))
        m_all = parts[0][0]
        for m, _, _ in parts[1:]:
            m_all = torch.maximum(m_all, m)
        l = torch.zeros_like(m_all)
        acc = torch.zeros(b, h, q1 - q0, hd, device=q.device)
        for m, l_z, acc_z in parts:
            w = torch.exp(m - m_all)
            l = l + l_z * w
            acc = acc + acc_z * w
        out[:, :, q0:q1] = acc * (1.0 / l.clamp_min(1e-30))
    return out.transpose(1, 2).to(q.dtype)


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
    lib.flash_attention.argtypes = [p, p, p, p, p, p, i, i, i, i, i, f, i, i,
                                    i, i, i, i, p]
    lib.flash_attention.restype = i
    return lib


def _launch(q, k, v, *, causal: bool, window: int,
            splits: int = 0) -> torch.Tensor:
    """One kernel launch (and, with a key split, its merge).  ``splits``
    0 takes ``key_splits``; chip_smoke.py forces it to compare both."""
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: the CUDA kernel takes contiguous "
                         "q, k, v")
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if splits <= 0:
        splits = key_splits(b, h, sq, sk, hd)
    part_acc = part_ml = None
    if splits > 1:
        part_acc = torch.empty(splits, b * h, sq, hd, dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty(splits, b * h, sq, 2, dtype=torch.float32,
                              device=q.device)
    vec = (hd * q.element_size()) % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (q, k, v, out))
    lib = _lib()
    err = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if part_acc is None else part_acc.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(), b, sq, sk, h, hd,
        1.0 / math.sqrt(hd), int(causal), int(window), query_tile(sq),
        splits, int(vec), _DTYPES[q.dtype], _build.stream_handle())
    _build.check(lib, "flash_attention", err)
    trace.count("launches.flash_attention")
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
