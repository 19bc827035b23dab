"""xLSTM-1.3B [arXiv:2405.04517; unverified] — mLSTM/sLSTM recurrent LM.

xLSTM[7:1]: one sLSTM block per 8-block group, rest mLSTM.  d_ff=0 in the
assignment: blocks carry their own up/down projection (expand factor 2),
no separate FFN.  O(1)-state decode -> runs long_500k.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    ssm_expand=2, xlstm_slstm_every=8,
    notes="mLSTM matrix memory (d_head x d_head state per head); "
          "4 heads (attention-free; heads shard only when divisible)",
)
