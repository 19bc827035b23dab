"""Qwen2-VL-72B [arXiv:2409.12191; hf] — VLM backbone (GQA + M-RoPE).

The vision frontend (dynamic-resolution patch encoder) is a STUB per the
assignment: ``input_specs()`` supplies precomputed patch embeddings; this
config covers the 80-layer text backbone with M-RoPE.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab_size=152064, rope_theta=1e6,
    mrope_sections=(16, 24, 24),
    notes="M-RoPE 3D sections over head_dim/2=64; text positions "
          "degenerate to standard RoPE",
)
