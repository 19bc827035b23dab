"""Public wrappers over the port's kernels, as ``repro.kernels.ops``.

The same five entry points with the same arguments.  There is no
``interpret`` flag: a CUDA tensor launches the hand-written kernel and a
CPU tensor takes its plain PyTorch version (``kernels/__init__.py``).
"""

from __future__ import annotations

import torch

from .crossbar_gemm import crossbar_gemm
from .fb_epilogue import fb_epilogue
from .flash_attention import flash_attention
from .fused_gemm_epilogue import fused_gemm_epilogue
from .packed_gemm import packed_gemm, pad_groups, tile_group_map


def crossbar_matmul_int8(x, w, *, adc_bits: int = 9, rows: int = 512,
                         exact: bool | None = None):
    """HURRY crossbar GEMM; ``exact=None`` takes the clip-free branch when
    ``rows <= 2^adc_bits - 1`` (``crossbar_gemm.clip_possible``)."""
    return crossbar_gemm(x, w, adc_bits=adc_bits, rows=rows, exact=exact)


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              block_q: int = 128, block_k: int = 128):
    """GQA-aware entry: repeats each kv head ``H // H_kv`` times, then
    runs ``flash_attention``."""
    h, hkv = q.shape[2], k.shape[2]
    if hkv != h:
        if h % hkv:
            raise ValueError(f"attention: {h} query heads are not a "
                             f"multiple of {hkv} kv heads")
        k = torch.repeat_interleave(k, h // hkv, dim=2)
        v = torch.repeat_interleave(v, h // hkv, dim=2)
    return flash_attention(q, k, v, causal=causal, window=window,
                           block_q=block_q, block_k=block_k)


def linear_fused(x, w, b, residual=None, *, act: str = "silu"):
    """x @ w + b -> act -> (+ residual), one ``fused_gemm_epilogue``."""
    return fused_gemm_epilogue(x, w, b, residual, act=act)


def fb_postops(y, scale, bias, residual=None, **kw):
    """Fused FB epilogue over an int32 crossbar GEMM output; keyword
    arguments as ``fb_epilogue`` (act/pool/window/img_hw/softmax/...)."""
    return fb_epilogue(y, scale, bias, residual, **kw)


def grouped_gemm(x, w, group_sizes, *, block_m: int = 128,
                 block_n: int = 128):
    """Pad the groups, map the tiles, run ``packed_gemm``, unpad.

    The tile map is built on the host from ``pad_groups``' host-side
    sizes and sent to the device once, by the launch; the unpad is one
    gather over the inverse permutation that ``pad_groups`` planned.
    """
    xp, padded_sizes, _, inv_index = pad_groups(x, group_sizes, block_m)
    n_tiles = xp.shape[0] // block_m
    gids = tile_group_map(padded_sizes, block_m, n_tiles)
    yp = packed_gemm(xp, w, gids, block_m=block_m, block_n=block_n)
    return yp[inv_index.long()]


__all__ = ["crossbar_matmul_int8", "attention", "linear_fused", "fb_postops",
           "grouped_gemm", "packed_gemm", "pad_groups", "tile_group_map",
           "flash_attention", "fused_gemm_epilogue", "fb_epilogue",
           "crossbar_gemm"]
