"""Phi-3-medium-14B [arXiv:2404.14219; unverified] — dense GQA decoder."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10,
    d_ff=17920, vocab_size=100352, rope_theta=1e4,
    notes="RoPE SwiGLU GQA kv=10; 40 heads (not divisible by TP=16: "
          "attention shards on d_model, see sharding/rules.py)",
)
