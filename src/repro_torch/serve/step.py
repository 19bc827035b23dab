"""Serving steps: prefill (long-prompt forward) and single-token decode.

The port of ``repro.serve.step``.  ``make_decode_step`` builds the step
that serves one new token against a KV cache / recurrent state;
``make_prefill_step`` the full forward over a prompt returning
last-position logits (above 2048 tokens the chunked attention keeps the
score buffer bounded; see ``models.layers.mha_chunked``).  Both compute
in bfloat16, the JAX package's default.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.sharding import context as shctx


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, tokens, frames: Optional[torch.Tensor] = None):
        logits = lm.forward(params, cfg, tokens, encoder_input=frames)
        return logits[:, -1]
    return prefill_step


def make_decode_step(cfg: ModelConfig, compute_dtype=torch.bfloat16):
    """The greedy decode step, computing in ``compute_dtype`` (the JAX
    package's bfloat16 unless the caller asks for another)."""
    def serve_step(params, token, caches, position,
                   encoder_states: Optional[torch.Tensor] = None):
        logits, new_caches = lm.decode_step(
            params, cfg, token, caches, position,
            encoder_states=encoder_states, compute_dtype=compute_dtype)
        # the vocabulary whole on each rank: DTensor's argmax over a
        # sharded dim is not available in every torch version
        next_tok = shctx.unshard(logits[:, -1], -1).argmax(-1) \
            .to(torch.int32)
        return next_tok[:, None], logits, new_caches
    return serve_step


def greedy_generate(cfg: ModelConfig, params, prompt: torch.Tensor,
                    max_new: int, max_len: int = 0,
                    encoder_states: Optional[torch.Tensor] = None):
    """Simple batched greedy decode loop (examples / tests).

    Runs on the device of ``params``; the loop never waits for the
    device (positions live there, the next token stays there).
    """
    b, s = prompt.shape
    max_len = max_len or (s + max_new)
    caches = lm.init_caches(cfg, b, max_len, params=params)
    decode = make_decode_step(cfg)
    positions = torch.arange(s + max_new, dtype=torch.int32,
                             device=prompt.device)
    # prefill token-by-token (correct for every family incl. SSM states)
    tok = prompt[:, :1]
    out = [tok]
    for i in range(s + max_new - 1):
        nxt, _, caches = decode(params, tok, caches, positions[i],
                                encoder_states=encoder_states)
        tok = prompt[:, i + 1:i + 2] if i + 1 < s else nxt
        out.append(tok)
    return torch.cat(out, 1)
