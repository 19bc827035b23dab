"""Whisper-medium [arXiv:2212.04356; unverified] — enc-dec audio backbone.

Conv frontend is a STUB per the assignment: ``input_specs()`` supplies
precomputed frame embeddings (1500 frames) to the 24-layer encoder; the
24-layer decoder (self + cross attention) carries the decode shapes.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=51865,
    encoder_layers=24, encoder_seq=1500,
    norm="layernorm", act="gelu", rope_theta=0.0,
    notes="enc-dec; learned positions (rope_theta=0 -> sinusoidal/learned "
          "positional path); MHA kv=16",
)
