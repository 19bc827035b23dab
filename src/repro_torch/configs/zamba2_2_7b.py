"""Zamba2-2.7B [arXiv:2411.15242; hf] — hybrid Mamba2 + shared attention.

54 Mamba2 blocks with ONE shared transformer block applied every 6 blocks
(weights reused each application, Zamba-style).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_heads=40, ssm_expand=2, ssm_conv=4,
    shared_attn_every=6,
    notes="Mamba2 backbone (state=64) + shared MHA block; long_500k runs "
          "on the SSM path with windowed shared attention",
    sliding_window=4096,
)
