"""int8 KV-cache quantization (per-head symmetric scales).

The port of ``repro.serve.kv_quant``.  The decode floor is KV-cache
bytes / memory bandwidth; int8 K/V halves the bf16 cache's.  Layout
mirrors the bf16 cache: {"k": int8 (B,S,Hkv,hd), "k_scale": f32
(B,S,Hkv), ..., "index"} — per-(position, head) scales keep the dequant
error at the quantization-noise floor (KIVI-style per-token scaling).
The int8 values and scales equal eager JAX's bit for bit, on the CPU
and on the GPU: true divisions, rounding half to even.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.layers import dynamic_update_slice


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., hd) -> int8 values + per-(...,) scale."""
    xf = x.float()
    amax = xf.abs().amax(-1)
    # a true division on every device: on a CUDA tensor, dividing by a
    # Python number multiplies by its reciprocal instead (1 ulp off JAX)
    scale = amax.clamp_min(1e-8) / torch.full((), 127.0, device=x.device)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def init_quant_kv_cache(batch: int, max_len: int, cfg, *,
                        device=None) -> dict:
    dev = resolve_device(device)
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    length = min(max_len, cfg.sliding_window) if cfg.sliding_window \
        else max_len
    return {
        "k": torch.zeros((batch, length, hkv, hd), dtype=torch.int8,
                         device=dev),
        "k_scale": torch.zeros((batch, length, hkv), device=dev),
        "v": torch.zeros((batch, length, hkv, hd), dtype=torch.int8,
                         device=dev),
        "v_scale": torch.zeros((batch, length, hkv), device=dev),
        "index": torch.zeros((), dtype=torch.int32, device=dev),
    }


def update_quant_cache(cache: dict, k: torch.Tensor, v: torch.Tensor
                       ) -> dict:
    """Append one step's K/V (B, s, Hkv, hd) at the cache index (a ring
    buffer over the cache's length)."""
    idx = cache["index"]
    s = k.shape[1]
    slot = idx % cache["k"].shape[1]
    qk, sk = quantize_kv(k)
    qv, sv = quantize_kv(v)
    return {
        "k": dynamic_update_slice(cache["k"], qk, slot),
        "k_scale": dynamic_update_slice(cache["k_scale"], sk, slot),
        "v": dynamic_update_slice(cache["v"], qv, slot),
        "v_scale": dynamic_update_slice(cache["v_scale"], sv, slot),
        "index": idx + s,
    }


def read_quant_cache(cache: dict, dtype=torch.bfloat16
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    k = dequantize_kv(cache["k"], cache["k_scale"], dtype)
    v = dequantize_kv(cache["v"], cache["v_scale"], dtype)
    return k, v
