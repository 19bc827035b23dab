"""Sequence-workload helpers: token layout + the attention logit scale.

The port of ``repro.program.sequence``.  ``attn_scale`` is what the
compiler folds into the scores stage; the layout helpers are what the
executor's dynamic-operand (attention) stages split heads with, and
the functional model merges them with (the executor's context stage
stores them merged).  Reshape/transpose only, plus one Python float
constant.
"""

from __future__ import annotations

import math

import torch

# one implementation, the epilogue kernel's plain version's
from repro_torch.kernels.fb_epilogue import merge_heads  # noqa: F401


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


def qkv_head_views(qkv: torch.Tensor, heads: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, T, 3D) fused-projection buffer -> three (B, heads, T, hd)
    views of it (permuted, not copied)."""
    D = qkv.shape[-1] // 3
    return tuple(qkv[..., i * D:(i + 1) * D].unflatten(-1, (heads, -1))
                 .transpose(1, 2) for i in range(3))


def split_qkv_heads(qkv: torch.Tensor, heads: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, T, 3D) fused-projection buffer -> three (B*heads, T, hd).

    The leading axis is (batch, head) row-major: one entry per mounted
    attention matrix.
    """
    return tuple(u.flatten(0, 1) for u in qkv_head_views(qkv, heads))


