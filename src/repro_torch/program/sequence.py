"""Sequence-workload helpers: token layout + the attention logit scale.

The port of ``repro.program.sequence``.  ``attn_scale`` is what the
compiler folds into the scores stage; the layout helpers are what the
executor's dynamic-operand stages (the next slice) split and merge heads
with.  Reshape/transpose only, plus one Python float constant.
"""

from __future__ import annotations

import math

import torch


def attn_scale(head_dim: int) -> float:
    """The scores scale `1/sqrt(head_dim)` (paper Eq. 1's logit scale)."""
    return 1.0 / math.sqrt(head_dim)


def tokens(x: torch.Tensor) -> torch.Tensor:
    """Canonicalize a buffer to the (B, T, D) token layout.

    Spatial NHWC buffers map row-major: token ``t = row * W + col`` (the
    standard ViT rasterization).  Token buffers pass through unchanged.
    """
    if x.dim() == 4:
        return x.reshape(x.shape[0], -1, x.shape[-1])
    return x


def split_qkv_heads(qkv: torch.Tensor, heads: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, T, 3D) fused-projection buffer -> three (B*heads, T, hd).

    The leading axis is (batch, head) row-major: one entry per mounted
    attention matrix.
    """
    B, T, three_d = qkv.shape
    D = three_d // 3
    hd = D // heads

    def sp(u):
        return (u.reshape(B, T, heads, hd).permute(0, 2, 1, 3)
                .reshape(B * heads, T, hd))

    return sp(qkv[..., :D]), sp(qkv[..., D:2 * D]), sp(qkv[..., 2 * D:])


def merge_heads(ctx: torch.Tensor, heads: int) -> torch.Tensor:
    """(B*heads, T, hd) attention context -> (B, T, heads*hd)."""
    bh, T, hd = ctx.shape
    B = bh // heads
    return (ctx.reshape(B, heads, T, hd).permute(0, 2, 1, 3)
            .reshape(B, T, heads * hd))
