"""Model configuration schema for the LM framework.

One ``ModelConfig`` describes any of the 10 assigned architectures
(dense / MoE / SSM / hybrid / VLM-backbone / audio enc-dec).  Reduced
configs (for CPU smoke tests) are derived with ``reduced()``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    # attention
    qk_norm: bool = False
    rope_theta: float = 1e4
    mrope_sections: Optional[tuple[int, ...]] = None   # Qwen2-VL M-RoPE
    sliding_window: int = 0      # 0 = full attention
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    # SSM (Mamba2)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    # hybrid (Zamba2): one shared attention block every N mamba blocks
    shared_attn_every: int = 0
    # xLSTM: blocks per group, one sLSTM per group (xLSTM[m:s] layout)
    xlstm_slstm_every: int = 0
    # encoder-decoder (Whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0         # stubbed frontend output length
    # misc
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "silu"
    norm: str = "rmsnorm"        # rmsnorm|layernorm
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (embedding sharding)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode path exists (SSM / hybrid / SWA)."""
        return (self.family in ("ssm", "hybrid")
                or self.sliding_window > 0)

    def reduced(self) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        def shrink(v, target):
            return min(v, target) if v else v
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 4 if not self.shared_attn_every
                         else max(4, self.shared_attn_every)),
            d_model=shrink(self.d_model, 64),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=16,
            d_ff=shrink(self.d_ff, 128) or 0,
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            experts_per_token=min(self.experts_per_token, 2)
            if self.experts_per_token else 0,
            ssm_state=shrink(self.ssm_state, 16),
            ssm_heads=min(self.ssm_heads, 2) if self.ssm_heads else 0,
            sliding_window=min(self.sliding_window, 64)
            if self.sliding_window else 0,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 32) if self.encoder_seq else 0,
            shared_attn_every=min(self.shared_attn_every, 2)
            if self.shared_attn_every else 0,
            xlstm_slstm_every=min(self.xlstm_slstm_every, 2)
            if self.xlstm_slstm_every else 0,
        )


# ---------------------------------------------------------------------------
# Shapes (assigned): every arch is exercised on these four cells
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
