"""Qwen3-8B [hf:Qwen/Qwen3-8B; hf] — dense GQA decoder with qk-norm."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12288, vocab_size=151936, head_dim=128, qk_norm=True,
    rope_theta=1e6,
    notes="qk_norm per-head RMSNorm; GQA kv=8",
)
