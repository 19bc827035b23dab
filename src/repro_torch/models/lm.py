"""Generic LM assembly for all assigned architecture families.

The port of ``repro.models.lm``.  ``init_params(cfg, generator)`` builds
a tree with per-layer weights stacked on a leading layer axis (the JAX
package's pytree, key for key, so ``convert.tree_from_jax`` carries its
parameters across unchanged); ``forward`` / ``decode_step`` loop over
that axis in Python where the JAX package runs ``jax.lax.scan``.

Families:
  dense | moe | vlm      — pre-norm decoder blocks (attention + MLP/MoE);
                           vlm shares the text path (vision frontend is a
                           stub supplying embeddings / M-RoPE positions)
  ssm (xlstm)            — groups of (k-1) mLSTM + 1 sLSTM blocks
  hybrid (zamba2)        — groups of k Mamba2 blocks + ONE shared
                           attention block applied after each group
                           (weights reused; per-application KV caches)
  audio (whisper)        — encoder (full attn over stubbed frame
                           embeddings) + decoder (causal self + cross)

Training differentiates ``forward`` with ``torch.autograd``.  Its
``remat=True`` recomputes each block's activations in the backward pass
(``torch.utils.checkpoint``) where the JAX package wraps the same block
bodies in ``jax.checkpoint``; the loops take the stacked weights apart
with one ``unbind`` per leaf, whose backward pass is one ``stack``.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.sharding import context as shctx
from repro_torch.tree import tree_map

from . import layers as L


def _unstack(tree) -> list:
    """The per-layer trees of a tree stacked on a leading axis.

    One ``unbind`` per leaf: its backward pass stacks the layers'
    gradients once, where indexing layer ``i`` (``t[i]``) would write a
    zero tensor of the whole stack and add into it for every layer.
    """
    if isinstance(tree, dict):
        parts = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(tree.unbind(0))


def _remat(body, remat: bool):
    """``body``, recomputed in the backward pass when ``remat`` (the JAX
    package's ``jax.checkpoint``); the bodies draw no random numbers."""
    if not remat:
        return body
    return partial(checkpoint, body, use_reentrant=False,
                   preserve_rng_state=False)


def _stack(trees: list):
    """The per-layer trees stacked back on a leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows ``tokens`` of the embedding table.

    On a DTensor table the vocabulary rows stay where they are: each
    rank looks up the tokens in its own block of rows (zero for the
    rest), the d_model columns gathered, and the blocks sum over the
    vocab axis's ranks (a ``Partial`` result, constrained to the residual
    stream's spec).  DTensor has no strategy for a row index into a
    vocab-sharded table, and its ``embedding`` strategy's masked partial
    cannot take the gradient of the constraint after it.
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(table, DTensor):
        return table[tokens]
    mesh = table.device_mesh
    table = shctx.unshard(table, 1)
    lo, block, vocab_axes = shctx.local_block(table, 0)
    pl = tuple(Replicate() if i in vocab_axes else p
               for i, p in enumerate(tokens.placements))
    local = tokens.redistribute(mesh, pl).to_local() - lo
    inside = (local >= 0) & (local < block)
    # the table's gradient differs between ranks holding other tokens
    grad_pl = tuple(Partial() if p.is_shard() else q
                    for p, q in zip(pl, table.placements))
    rows = F.embedding(local.clamp(0, block - 1),
                       table.to_local(grad_placements=grad_pl))
    rows = torch.where(inside[..., None], rows, 0.0)
    return shctx.constrain_resid(DTensor.from_local(
        rows, mesh, tuple(Partial() if i in vocab_axes else p
                          for i, p in enumerate(pl)), run_check=False))


def _sinusoidal(positions: torch.Tensor, d: int, dtype) -> torch.Tensor:
    half = d // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.float32, device=None) -> dict:
    """Random parameters: the JAX package's tree, shapes and scales.

    Draws come from ``generator`` on its own device (``jax.random`` draws
    cannot be reproduced; to compute on the JAX package's weights, carry
    them across with ``convert.tree_from_jax``).  Float leaves are cast to
    ``dtype``; build them in the compute dtype to serve, since the layers
    cast parameters at every use.  The cast goes leaf by leaf, each
    float32 leaf dropped as its copy is made, so the peak is the float32
    tree plus one leaf: the float32 tree and a whole bfloat16 copy of
    Phi-3-medium's do not fit one 80 GB card together.  ``device``
    defaults to the GPU.
    """
    dev = resolve_device(device)
    g = generator
    d, hd = cfg.d_model, cfg.resolved_head_dim
    params: dict[str, Any] = {
        "embed": L._normal(g, (cfg.padded_vocab, d), 0.02, dev),
        "final_norm": L.init_norm(d, cfg.norm, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L._normal(g, (d, cfg.padded_vocab), 0.02, dev)

    def block_init(stack):
        blk = {"ln1": L.init_norm(d, cfg.norm, device=dev, stack=stack),
               "attn": L.init_attention(g, d, cfg.n_heads, cfg.n_kv_heads,
                                        hd, cfg.qk_norm, device=dev,
                                        stack=stack),
               "ln2": L.init_norm(d, cfg.norm, device=dev, stack=stack)}
        if cfg.n_experts:
            blk["moe"] = L.init_moe(g, d, cfg.d_ff, cfg.n_experts,
                                    device=dev, stack=stack)
        else:
            blk["mlp"] = L.init_mlp(g, d, cfg.d_ff, device=dev, stack=stack)
        return blk

    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        params["blocks"] = block_init((cfg.n_layers,))
    elif fam == "hybrid":
        stack = (cfg.n_layers // cfg.shared_attn_every, cfg.shared_attn_every)
        params["groups"] = {
            "ln": L.init_norm(d, cfg.norm, device=dev, stack=stack),
            "mamba": L.init_mamba2(g, d, cfg, device=dev, stack=stack)}
        params["shared"] = block_init(())            # ONE shared attn block
        # initialised but never read, as in the JAX package's tree
        params["shared_ln"] = L.init_norm(d, cfg.norm, device=dev)
    elif fam == "ssm":
        k_grp = cfg.xlstm_slstm_every
        n_groups = cfg.n_layers // k_grp
        ml, sl = (n_groups, k_grp - 1), (n_groups,)
        params["groups"] = {
            "mlstm": {"ln": L.init_norm(d, cfg.norm, device=dev, stack=ml),
                      "cell": L.init_mlstm(g, d, cfg, device=dev, stack=ml)},
            "slstm": {"ln": L.init_norm(d, cfg.norm, device=dev, stack=sl),
                      "cell": L.init_slstm(g, d, cfg, device=dev, stack=sl)},
        }
    elif fam == "audio":
        enc = (cfg.encoder_layers,)
        params["enc_blocks"] = {
            "ln1": L.init_norm(d, cfg.norm, device=dev, stack=enc),
            "attn": L.init_attention(g, d, cfg.n_heads, cfg.n_kv_heads, hd,
                                     device=dev, stack=enc),
            "ln2": L.init_norm(d, cfg.norm, device=dev, stack=enc),
            "mlp": L.init_mlp(g, d, cfg.d_ff, device=dev, stack=enc)}
        dec = (cfg.n_layers,)
        params["dec_blocks"] = {
            "ln1": L.init_norm(d, cfg.norm, device=dev, stack=dec),
            "self_attn": L.init_attention(g, d, cfg.n_heads, cfg.n_kv_heads,
                                          hd, device=dev, stack=dec),
            "ln_x": L.init_norm(d, cfg.norm, device=dev, stack=dec),
            "cross_attn": L.init_attention(g, d, cfg.n_heads, cfg.n_kv_heads,
                                           hd, device=dev, stack=dec),
            "ln2": L.init_norm(d, cfg.norm, device=dev, stack=dec),
            "mlp": L.init_mlp(g, d, cfg.d_ff, device=dev, stack=dec)}
        params["enc_norm"] = L.init_norm(d, cfg.norm, device=dev)
    else:
        raise ValueError(f"unknown family {fam}")

    return _cast_leaves(params, dtype)


def _cast_leaves(tree: dict, dtype) -> dict:
    """``tree``'s float32 leaves cast to ``dtype`` one at a time, in
    place: each float32 leaf is released once its copy replaces it."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _cast_leaves(v, dtype)
        elif v.dtype == torch.float32:
            tree[k] = v.to(dtype)
    return tree


# ---------------------------------------------------------------------------
# forward (prefill without cache)
# ---------------------------------------------------------------------------

def _decoder_block(blk, x, positions, cfg, kv_cache=None, cross=None):
    h, new_cache = L.attention(
        blk["attn"] if "attn" in blk else blk["self_attn"],
        L.apply_norm(x, blk["ln1"], cfg.norm, cfg.norm_eps),
        positions, cfg, kv_cache=kv_cache)
    x = x + h
    if cross is not None:
        hc, _ = L.attention(blk["cross_attn"],
                            L.apply_norm(x, blk["ln_x"], cfg.norm,
                                         cfg.norm_eps),
                            positions, cfg, causal=False, cross_kv=cross)
        x = x + hc
    y = L.apply_norm(x, blk["ln2"], cfg.norm, cfg.norm_eps)
    if "moe" in blk:
        x = x + L.moe(blk["moe"], y, cfg.n_experts, cfg.experts_per_token,
                      cfg.act)
    else:
        x = x + L.mlp(blk["mlp"], y, cfg.act)
    return x, new_cache


def encode(params: dict, cfg: ModelConfig, frames: torch.Tensor,
           compute_dtype=torch.bfloat16,
           remat: bool = False) -> torch.Tensor:
    """Whisper encoder: stubbed frame embeddings -> encoder states.

    Serving computes this once at prefill; ``decode_step`` consumes the
    result as ``encoder_states``.
    """
    enc = frames.to(compute_dtype)
    enc_pos = torch.arange(enc.shape[1], device=enc.device)[None] \
        .expand(enc.shape[:2])
    enc = enc + _sinusoidal(enc_pos, cfg.d_model, compute_dtype)

    def enc_body(ec, blk):
        h, _ = L.attention(blk["attn"],
                           L.apply_norm(ec, blk["ln1"], cfg.norm,
                                        cfg.norm_eps),
                           enc_pos, cfg, causal=False)
        ec = ec + h
        return ec + L.mlp(blk["mlp"],
                          L.apply_norm(ec, blk["ln2"], cfg.norm,
                                       cfg.norm_eps), cfg.act)
    enc_body = _remat(enc_body, remat)
    for blk in _unstack(params["enc_blocks"]):
        enc = enc_body(enc, blk)
    return L.apply_norm(enc, params["enc_norm"], cfg.norm, cfg.norm_eps)


def _cross_kv(blk, states, b, cfg, dtype):
    """One decoder block's cross-attention K/V from the encoder states."""
    hd = cfg.resolved_head_dim
    ca = blk["cross_attn"]
    return ((states @ ca["wk"].to(dtype)).reshape(b, -1, cfg.n_kv_heads, hd),
            (states @ ca["wv"].to(dtype)).reshape(b, -1, cfg.n_kv_heads, hd))


def _logits(params, cfg, x):
    x = L.apply_norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    head = params.get("lm_head", None)
    if head is None:
        head = params["embed"].T
    return x @ head.to(x.dtype)


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            encoder_input: Optional[torch.Tensor] = None,
            compute_dtype=torch.bfloat16,
            remat: bool = False) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, padded_vocab).

    ``remat`` recomputes, in the backward pass, the bodies the JAX
    package wraps in ``jax.checkpoint``: every decoder block, the Mamba2
    and mLSTM bodies (not the shared attention block or the sLSTM), and
    Whisper's encoder and decoder blocks.  The logits do not change.
    """
    b, s = tokens.shape
    x = _embed(params["embed"], tokens).to(compute_dtype)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        if cfg.mrope_sections:
            positions = positions[None].expand(3, b, s)
    if cfg.rope_theta <= 0:          # absolute sinusoidal positions
        pos2d = positions if positions.ndim == 2 else positions[0]
        x = x + _sinusoidal(pos2d, cfg.d_model, compute_dtype)

    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        body = _remat(lambda xc, blk: _decoder_block(blk, xc, positions,
                                                     cfg)[0], remat)
        for blk in _unstack(params["blocks"]):
            x = body(x, blk)
    elif fam == "hybrid":
        def mamba_body(xi, lp):
            return xi + L.mamba2(lp["mamba"],
                                 L.apply_norm(xi, lp["ln"], cfg.norm,
                                              cfg.norm_eps), cfg)
        mamba_body = _remat(mamba_body, remat)
        for grp in _unstack(params["groups"]):
            for lp in _unstack(grp):
                x = mamba_body(x, lp)
            x, _ = _decoder_block(params["shared"], x, positions, cfg)
    elif fam == "ssm":
        def ml_body(xi, lp):
            return xi + L.mlstm(lp["cell"],
                                L.apply_norm(xi, lp["ln"], cfg.norm,
                                             cfg.norm_eps), cfg)
        ml_body = _remat(ml_body, remat)
        for grp in _unstack(params["groups"]):
            for lp in _unstack(grp["mlstm"]):
                x = ml_body(x, lp)
            sl = grp["slstm"]
            x = x + L.slstm(sl["cell"],
                            L.apply_norm(x, sl["ln"], cfg.norm,
                                         cfg.norm_eps), cfg)
    elif fam == "audio":
        if encoder_input is None:
            raise ValueError("whisper needs frame embeddings "
                             "(encoder_input)")
        enc = encode(params, cfg, encoder_input, compute_dtype, remat)

        def dec_body(xc, blk):
            # this block's cross K/V from the encoder states, inside the
            # rematerialised body as in the JAX package
            return _decoder_block(blk, xc, positions, cfg,
                                  cross=_cross_kv(blk, enc, b, cfg,
                                                  xc.dtype))[0]
        dec_body = _remat(dec_body, remat)
        for blk in _unstack(params["dec_blocks"]):
            x = dec_body(x, blk)
    else:
        raise ValueError(fam)
    return _logits(params, cfg, x)


# ---------------------------------------------------------------------------
# serving: cache init + decode step
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, params: Optional[dict] = None,
                device=None) -> dict:
    """Stacked per-layer decode state for the family.

    ``device`` defaults to the device of ``params`` when given, else to
    the GPU.
    """
    if device is None and params is not None:
        device = params["embed"].device
    dev = resolve_device(device)
    fam = cfg.family

    def kv(n):
        c = L.init_kv_cache(batch, max_len, cfg, dtype, device=dev)
        return tree_map(lambda t: t.expand((n,) + t.shape).clone(), c)

    if fam in ("dense", "moe", "vlm"):
        return {"kv": kv(cfg.n_layers)}
    if fam == "hybrid":
        n_groups = cfg.n_layers // cfg.shared_attn_every
        d_inner = cfg.ssm_expand * cfg.d_model
        h = cfg.ssm_heads or max(1, d_inner // 64)
        hd = d_inner // h
        lead = (n_groups, cfg.shared_attn_every, batch)
        ssm = {"ssm": torch.zeros(lead + (h, cfg.ssm_state, hd), device=dev),
               "conv": torch.zeros(lead + (cfg.ssm_conv - 1,
                                           d_inner + 2 * cfg.ssm_state),
                                   device=dev)}
        return {"mamba": ssm, "kv": kv(n_groups)}
    if fam == "ssm":
        k_grp = cfg.xlstm_slstm_every
        n_groups = cfg.n_layers // k_grp
        d_inner = cfg.ssm_expand * cfg.d_model
        h = cfg.n_heads
        hd = d_inner // h
        lead = (n_groups, k_grp - 1, batch, h)
        ml = {"C": torch.zeros(lead + (hd, hd), device=dev),
              "n": torch.zeros(lead + (hd,), device=dev),
              "m": torch.full(lead, -30.0, device=dev)}
        sl = tree_map(lambda t: t.expand((n_groups,) + t.shape).clone(),
                       L.init_slstm_state(batch, cfg.d_model, dtype,
                                          device=dev))
        return {"mlstm": ml, "slstm": sl}
    if fam == "audio":
        return {"kv": kv(cfg.n_layers)}   # self-attn caches; cross computed
    raise ValueError(fam)


def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                caches: dict, position,
                encoder_states: Optional[torch.Tensor] = None,
                compute_dtype=torch.bfloat16) -> tuple[torch.Tensor, dict]:
    """One-token decode: token (B, 1) -> logits (B, 1, V), new caches.

    ``position`` is the token's absolute position: an int or a 0-d
    integer tensor.  ``caches`` is left as it is; the new state is
    returned.
    """
    b = token.shape[0]
    x = _embed(params["embed"], token).to(compute_dtype)
    positions = torch.as_tensor(position, device=x.device).reshape(1, 1) \
        .expand(b, 1)
    if cfg.mrope_sections:
        positions = positions[None].expand(3, b, 1)
    if cfg.rope_theta <= 0:
        x = x + _sinusoidal(positions if positions.ndim == 2
                            else positions[0], cfg.d_model, compute_dtype)

    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        new_kv = []
        for blk, kv in zip(_unstack(params["blocks"]),
                           _unstack(caches["kv"])):
            x, nc = _decoder_block(blk, x, positions, cfg, kv_cache=kv)
            new_kv.append(nc)
        new_caches = {"kv": _stack(new_kv)}
    elif fam == "hybrid":
        shared = params["shared"]
        new_mamba, new_kv = [], []
        for grp, mamba_c, kv in zip(_unstack(params["groups"]),
                                    _unstack(caches["mamba"]),
                                    _unstack(caches["kv"])):
            states = []
            for lp, st in zip(_unstack(grp), _unstack(mamba_c)):
                h, nst = L.mamba2_step(
                    lp["mamba"], L.apply_norm(x, lp["ln"], cfg.norm,
                                              cfg.norm_eps), st, cfg)
                x = x + h
                states.append(nst)
            new_mamba.append(_stack(states))
            x, nc = _decoder_block(shared, x, positions, cfg, kv_cache=kv)
            new_kv.append(nc)
        new_caches = {"mamba": _stack(new_mamba), "kv": _stack(new_kv)}
    elif fam == "ssm":
        new_ml, new_sl = [], []
        for grp, ml_c, sl_c in zip(_unstack(params["groups"]),
                                   _unstack(caches["mlstm"]),
                                   _unstack(caches["slstm"])):
            states = []
            for lp, st in zip(_unstack(grp["mlstm"]), _unstack(ml_c)):
                h, nst = L.mlstm_step(
                    lp["cell"], L.apply_norm(x, lp["ln"], cfg.norm,
                                             cfg.norm_eps), st, cfg)
                x = x + h
                states.append(nst)
            new_ml.append(_stack(states))
            sl = grp["slstm"]
            h, nsl = L.slstm_step(
                sl["cell"], L.apply_norm(x, sl["ln"], cfg.norm,
                                         cfg.norm_eps), sl_c, cfg)
            x = x + h
            new_sl.append(nsl)
        new_caches = {"mlstm": _stack(new_ml), "slstm": _stack(new_sl)}
    elif fam == "audio":
        if encoder_states is None:
            raise ValueError("whisper decode needs encoder_states "
                             "(lm.encode of the frames)")
        new_kv = []
        for blk, kv in zip(_unstack(params["dec_blocks"]),
                           _unstack(caches["kv"])):
            x, nc = _decoder_block(
                blk, x, positions, cfg, kv_cache=kv,
                cross=_cross_kv(blk, encoder_states, b, cfg, x.dtype))
            new_kv.append(nc)
        new_caches = {"kv": _stack(new_kv)}
    else:
        raise ValueError(fam)
    return _logits(params, cfg, x), new_caches
