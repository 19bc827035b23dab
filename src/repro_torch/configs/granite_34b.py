"""Granite-34B-code [arXiv:2405.04324; hf] — llama-arch MQA decoder."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab_size=49152, rope_theta=1e4,
    notes="MQA (kv=1): KV replicated across TP shards",
)
