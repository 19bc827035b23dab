"""Granite-3.0-3B-A800M MoE [hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

Assigned config: 32L d_model=1536 24H (kv=8) d_ff=512/expert, 40 experts
top-8.  vocab 49155 padded to 49408 for sharding (see DESIGN.md §6).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab_size=49155, rope_theta=1e4,
    n_experts=40, experts_per_token=8,
    notes="fine-grained MoE: 40 experts x d_ff=512, top-8; 24 heads "
          "(attention shards on d_model for TP=16)",
)
