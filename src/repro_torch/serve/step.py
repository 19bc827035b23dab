"""Serving steps: prefill (long-prompt forward) and single-token decode.

The port of ``repro.serve.step``.  ``make_decode_step`` builds the step
that serves one new token against a KV cache / recurrent state;
``make_prefill_step`` the full forward over a prompt returning
last-position logits (above 2048 tokens the chunked attention keeps the
score buffer bounded; see ``models.layers.mha_chunked``).  Both compute
in bfloat16, the JAX package's default.

``compile_decode_step`` is the counterpart of the JAX serving entry
points' ``jax.jit(make_decode_step(cfg))``: on a CUDA device it captures
the step once per key (``decode_key``: batch, cache tree, compute dtype,
encoder states, params tree) as a CUDA graph (``DecodeExecutable``) and
replays it for every later token, the position a device scalar the graph
reads; on the CPU it is the eager step.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.sharding import context as shctx
from repro_torch.tree import tree_items, tree_leaves, tree_map


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


def decode_key(params, token: torch.Tensor, caches, compute_dtype,
               encoder_states: Optional[torch.Tensor] = None) -> tuple:
    """The key of a decode call's executable: the batch, each cache
    leaf's (path, shape, dtype) (which fixes the cache length), the
    compute dtype, the encoder states' (shape, dtype) or None, and each
    parameter leaf's (path, address, shape, dtype): a graph reads the
    tensors it was captured on, so another tree of the same shapes gets
    a key of its own.  The position is not part of it (the graph reads
    it from a device scalar)."""
    return (token.shape[0],
            tuple((p, tuple(t.shape), t.dtype) for p, t in tree_items(caches)),
            compute_dtype,
            None if encoder_states is None
            else (tuple(encoder_states.shape), encoder_states.dtype),
            tuple((p, t.data_ptr(), tuple(t.shape), t.dtype)
                  for p, t in tree_items(params)))


def _set_position(dst: torch.Tensor, position) -> None:
    if isinstance(position, torch.Tensor):
        dst.copy_(position)
    else:
        dst.fill_(position)


@dataclasses.dataclass
class DecodeExecutable:
    """The decode step on one key, captured as a CUDA graph.

    ``token`` ((B, 1) int32), ``position`` (0-d int32), ``caches`` and
    ``encoder_states`` are the static inputs the graph reads, ``next_tok``
    and ``logits`` the static outputs it writes.  The graph ends by
    copying the step's new caches into ``caches`` (a device copy per
    leaf), so after a replay ``caches`` holds the state after the step.
    ``params`` is the tree the graph reads, held so that its memory
    outlives the graph; ``capture_s`` is the host seconds of the eager
    warm-up and the capture.
    """

    graph: Any
    params: dict
    token: torch.Tensor
    position: torch.Tensor
    caches: dict
    encoder_states: Optional[torch.Tensor]
    next_tok: torch.Tensor
    logits: torch.Tensor
    pool: tuple
    capture_s: float

    @classmethod
    def capture(cls, step, params, token, caches, position,
                encoder_states=None, pool: tuple | None = None
                ) -> "DecodeExecutable":
        """Copy the inputs into static buffers, run ``step`` once eagerly
        on a side stream, then capture it into ``pool`` (a new pool when
        None).  The caller's caches are left as they were."""
        t0 = time.perf_counter()
        with torch.cuda.device(token.device):
            tok = torch.empty(token.shape, dtype=torch.int32,
                              device=token.device).copy_(token)
            pos = torch.zeros((), dtype=torch.int32, device=token.device)
            _set_position(pos, position)
            static = tree_map(torch.clone, caches)
            enc = None if encoder_states is None else encoder_states.clone()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                step(params, tok, static, pos, encoder_states=enc)
            torch.cuda.current_stream().wait_stream(side)
            pool = pool or torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool,
                                  capture_error_mode="thread_local"):
                nxt, logits, new = step(params, tok, static, pos,
                                        encoder_states=enc)
                for dst, src in zip(tree_leaves(static), tree_leaves(new)):
                    dst.copy_(src)
        return cls(graph=graph, params=params, token=tok, position=pos,
                   caches=static, encoder_states=enc, next_tok=nxt,
                   logits=logits, pool=pool,
                   capture_s=time.perf_counter() - t0)

    def __call__(self, token, caches, position, encoder_states=None):
        """Replay on these inputs: ``(next_tok, logits, caches)``.

        The token and the position are copied in; the caches and encoder
        states only where they are not this executable's own tensors, so
        a loop that passes back the caches it was given copies none.
        ``next_tok`` and ``logits`` are new tensors; ``caches`` is this
        executable's own tree, which its next call overwrites.
        """
        self.token.copy_(token)
        _set_position(self.position, position)
        for dst, src in zip(tree_leaves(self.caches), tree_leaves(caches)):
            if src is not dst:
                dst.copy_(src)
        if encoder_states is not None \
                and encoder_states is not self.encoder_states:
            self.encoder_states.copy_(encoder_states)
        self.graph.replay()
        return self.next_tok.clone(), self.logits.clone(), self.caches


class CompiledDecodeStep:
    """``make_decode_step(cfg, compute_dtype)`` with one executable per
    key, the counterpart of ``jax.jit`` of the step.

    Called as the step is, ``(params, token, caches, position,
    encoder_states=None) -> (next_tok, logits, caches)``.  On a CUDA
    device the first call of a key (``decode_key``) captures a
    ``DecodeExecutable`` into ``executables``, all of them in one memory
    pool, and every call replays its key's graph.  The caches it returns
    are the executable's own buffers: the next call of that key
    overwrites them (pass them back, as a decode loop does, and nothing
    is copied).  A capture that fails raises: nothing carries on eagerly
    on the card.  Under a sharding context with a mesh it raises (the
    eager ``make_decode_step`` serves there).  On the CPU it is the
    eager step, and ``executables`` stays empty.
    """

    def __init__(self, cfg: ModelConfig, compute_dtype=torch.bfloat16):
        self.compute_dtype = compute_dtype
        self.step = make_decode_step(cfg, compute_dtype)
        self.executables: dict[tuple, DecodeExecutable] = {}

    def __call__(self, params, token, caches, position,
                 encoder_states: Optional[torch.Tensor] = None):
        if not self._captures(token.device):
            return self.step(params, token, caches, position,
                             encoder_states=encoder_states)
        if getattr(shctx.get(), "mesh", None) is not None:
            raise RuntimeError(
                "compile_decode_step does not capture under a device mesh "
                "(the sequence-sharded decode runs collectives); serve "
                "with make_decode_step there")
        key = decode_key(params, token, caches, self.compute_dtype,
                         encoder_states)
        exe = self.executables.get(key)
        if exe is None:
            pool = (next(iter(self.executables.values())).pool
                    if self.executables else None)
            exe = self.executables[key] = self._capture(
                params, token, caches, position, encoder_states, pool)
        return exe(token, caches, position, encoder_states)

    def _captures(self, device: torch.device) -> bool:
        return device.type == "cuda"

    def _capture(self, params, token, caches, position, encoder_states,
                 pool) -> DecodeExecutable:
        return DecodeExecutable.capture(self.step, params, token, caches,
                                        position, encoder_states, pool)


def compile_decode_step(cfg: ModelConfig,
                        compute_dtype=torch.bfloat16) -> CompiledDecodeStep:
    """The decode step compiled as the JAX serving entry points jit it:
    one CUDA graph per key on the card, the eager step on the CPU (see
    ``CompiledDecodeStep``)."""
    return CompiledDecodeStep(cfg, compute_dtype)


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
