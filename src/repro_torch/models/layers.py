"""LM building blocks: norms, RoPE/M-RoPE, GQA attention (full / causal /
sliding-window), SwiGLU MLP, top-k MoE (sort-based dispatch, grouped
GEMM), Mamba2 (chunked SSD), mLSTM/sLSTM (xLSTM), KV caches.

The port of ``repro.models.layers``, function by function and in the same
names.  Conventions:

  * plain functions over parameter dicts of tensors (the JAX pytree's
    nesting and keys, so ``convert.tree_from_jax`` carries its weights
    across unchanged)
  * activations (B, S, D); heads split as (B, S, H, hd)
  * every sequence-mixing layer has a paired single-token ``*_step`` for
    decode, operating on an explicit recurrent state / KV cache; the
    functions never write into their arguments, they return new states
  * compute dtype is the dtype of the incoming activations; params are
    cast at use (``.to`` is free when the dtype already matches, so
    serve with parameters built in the compute dtype)
  * init functions draw from a ``torch.Generator`` on its own device and
    place the result on ``device`` (``None``: the GPU); ``stack`` gives
    leading axes drawn in one go, the port's form of ``jax.vmap`` over
    split keys that stacks per-layer weights

The matrix products are plain ``torch.matmul`` / ``einsum``, as the JAX
layers are plain ``jnp``: no kernel of ``repro_torch.kernels`` is on this
path.  Under a device mesh the parameters and activations are DTensors:
the layers constrain activations where the JAX package does
(``sharding.context``'s ``constrain_*``, which return their input itself
when no rules are active), and a one-token decode step over a cache whose
sequence is sharded on the ``"model"`` axis runs the sequence-sharded
flash decode (``_flash_decode_seqsharded``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.sharding import context as shctx


def _normal(gen: torch.Generator, shape: tuple, scale: float,
            device) -> torch.Tensor:
    """Standard normal draws times ``scale``, float32, on ``device``."""
    t = torch.randn(shape, generator=gen, device=gen.device)
    return t.mul_(scale).to(resolve_device(device))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    var = x.float().square().mean(-1, keepdim=True)
    out = x * torch.rsqrt(var + eps).to(x.dtype)
    return out * scale.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    out = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    return out * scale.to(x.dtype) + bias.to(x.dtype)


def apply_norm(x, p, kind: str, eps: float):
    if kind == "layernorm":
        return layer_norm(x, p["scale"], p["bias"], eps)
    return rms_norm(x, p["scale"], eps)


def init_norm(d: int, kind: str, *, device=None, stack: tuple = ()) -> dict:
    dev = resolve_device(device)
    p = {"scale": torch.ones(stack + (d,), device=dev)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(stack + (d,), device=dev)
    return p


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: Optional[tuple[int, ...]] = None
               ) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) or (3, B, S) for M-RoPE.

    M-RoPE (Qwen2-VL): head_dim/2 frequency slots are partitioned into
    ``sections`` (temporal, height, width); each section takes its angle
    from the corresponding position component.  For text, all three
    components are equal and M-RoPE degenerates to RoPE.
    """
    if theta <= 0:
        return x          # learned/sinusoidal-positions model (Whisper)
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    if positions.ndim == 2:
        ang = positions[..., None].float() * inv          # (B,S,hd/2)
    else:
        # (3, B, S) -> section-wise angles
        if mrope_sections is None:
            raise ValueError("(3, B, S) positions need mrope_sections")
        parts = []
        start = 0
        for comp, sec in enumerate(mrope_sections):
            parts.append(positions[comp][..., None].float()
                         * inv[start:start + sec])
            start += sec
        ang = torch.cat(parts, -1)                        # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x.chunk(2, -1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv: int, head_dim: int, qk_norm: bool = False, *,
                   device=None, stack: tuple = ()) -> dict:
    s = 1.0 / math.sqrt(d_model)
    p = {
        "wq": _normal(gen, stack + (d_model, n_heads * head_dim), s, device),
        "wk": _normal(gen, stack + (d_model, n_kv * head_dim), s, device),
        "wv": _normal(gen, stack + (d_model, n_kv * head_dim), s, device),
        "wo": _normal(gen, stack + (n_heads * head_dim, d_model), s, device),
    }
    if qk_norm:
        dev = resolve_device(device)
        p["q_norm"] = torch.ones(stack + (head_dim,), device=dev)
        p["k_norm"] = torch.ones(stack + (head_dim,), device=dev)
    return p


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, Hkv, hd) -> (B, S, H, hd) by group broadcast."""
    b, s, hkv, hd = k.shape
    rep = n_heads // hkv
    return k[:, :, :, None, :].expand(b, s, hkv, rep, hd) \
        .reshape(b, s, n_heads, hd)


def _softmax_eq1(scores: torch.Tensor) -> torch.Tensor:
    """The paper's Eq. 1 max-stabilized softmax over the last axis; a
    fully masked (all -inf) row gives zeros."""
    m = scores.amax(-1, keepdim=True).clamp_min(-1e30)
    ex = torch.exp(scores - m)
    return ex / ex.sum(-1, keepdim=True).clamp_min(1e-30)


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
          window: int) -> torch.Tensor:
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool, window: int = 0,
        q_offset: int = 0) -> torch.Tensor:
    """Reference attention with the paper's Eq. 1 max-stabilized softmax.

    q: (B, Sq, H, hd); k/v: (B, Sk, H, hd).  ``q_offset`` is the absolute
    position of q[0] (decode: Sk-1).  Sliding ``window`` > 0 restricts
    attention to the last ``window`` keys.
    """
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(sk, device=q.device)
    mask = _mask(qpos, kpos, causal, window)
    scores = scores.masked_fill(~mask[None, None], float("-inf"))
    probs = _softmax_eq1(scores)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def mha_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool, window: int = 0, chunk: int = 512,
                q_offset: int = 0) -> torch.Tensor:
    """Memory-bounded attention: a loop over query chunks (the JAX
    package's ``lax.scan``).

    Keeps the score buffer at (B, H, chunk, Sk) instead of (B, H, Sq, Sk).
    Sliding window: each query chunk slices the static band
    k[ci*chunk - window : ci*chunk + chunk], clipped into the sequence,
    so compute and memory drop from O(S) to O(window + chunk) per chunk.
    ``q_offset`` is the absolute position of q[0] (a rank's block of a
    sequence-sharded q; the band needs the whole sequence, ``sq == sk``).
    """
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    pad = (-sq) % chunk
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
    nq = q.shape[1] // chunk

    banded = window > 0 and sq == sk and window + chunk < sk
    band = (window + chunk) if banded else sk
    ar = torch.arange(max(chunk, band), device=q.device)
    outs = []
    for ci in range(nq):
        qc = q[:, ci * chunk:(ci + 1) * chunk]
        qpos = q_offset + ci * chunk + ar[:chunk]
        if banded:
            start = min(max(ci * chunk - window, 0), sk - band)
            kc, vc = k[:, start:start + band], v[:, start:start + band]
            kpos = start + ar[:band]
        else:
            kc, vc = k, v
            kpos = ar[:sk]
        scores = torch.einsum("bqhd,bkhd->bhqk", qc, kc) / math.sqrt(hd)
        mask = _mask(qpos, kpos, causal, window)
        scores = scores.masked_fill(~mask[None, None], float("-inf"))
        probs = _softmax_eq1(scores)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", probs.to(vc.dtype), vc))
    return torch.cat(outs, 1)[:, :sq]


# full-score attention is fine below this sequence length
_CHUNK_THRESHOLD = 2048


def _on_shards(core, q, k, v):
    """``core(q, k, v, q_offset)``, the attention core, on each rank's own
    blocks when ``q`` is a DTensor, else on the tensors themselves.

    Attention is independent per (batch row, head), and per query row
    given every key: each rank attends its block of q (batch, heads, or
    the sequence where ``constrain_heads`` shards q on it) to k and v
    redistributed to the same batch and head blocks and every key row.
    DTensor's einsum cannot run this itself: it merges (batch, heads)
    into one bmm dim, which has no sharding strategy while heads are
    sharded inside it.
    """
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          distribute_tensor)
    if not isinstance(q, DTensor):
        return core(q, k, v, 0)
    mesh = q.device_mesh
    h = q.shape[2]
    kv_pl = tuple(pl if pl.is_shard() and pl.dim in (0, 2) else Replicate()
                  for pl in q.placements)
    # ranks holding other query rows take other gradients of the same keys
    kv_grad = tuple(Partial() if pl.is_shard(1) else kv
                    for pl, kv in zip(q.placements, kv_pl))

    def local(t):
        if not isinstance(t, DTensor):
            t = distribute_tensor(t, mesh, kv_pl)
        if t.shape[2] != h:       # GQA: a rank's q heads need their groups
            t = _expand_kv(shctx.unshard(t, 2), h)
        return t.redistribute(mesh, kv_pl).to_local(grad_placements=kv_grad)

    q_offset = 0
    for i, pl in enumerate(q.placements):
        if pl.is_shard(1):
            q_offset = mesh.get_local_rank(i) * (q.shape[1]
                                                 // mesh.size(i))
    out = core(q.to_local(), local(k), local(v), q_offset)
    return DTensor.from_local(out, mesh, q.placements, run_check=False)


def dynamic_update_slice(buf: torch.Tensor, upd: torch.Tensor,
                         start: torch.Tensor) -> torch.Tensor:
    """``jax.lax.dynamic_update_slice`` along axis 1: a new tensor, with
    ``start`` clipped so that the update fits, as XLA clips it."""
    s = upd.shape[1]
    start = torch.clamp(torch.as_tensor(start, device=buf.device),
                        0, buf.shape[1] - s)
    rows = start.long() + torch.arange(s, device=buf.device)
    return buf.index_copy(1, rows, upd)


def _flash_decode_seqsharded(q, cache_k, cache_v, k_new, v_new, idx,
                             cfg, rules):
    """Sequence-sharded flash decode.

    The KV cache's seq dim is sharded on "model" (``rules.mesh``): instead
    of gathering the cache, each model shard updates its own slice (only
    where the index lands in it) and computes partial (m, l, o) softmax
    statistics over its keys; the shards combine them with all-reduces
    over the "model" group (MAX of m, SUM of l·α and o·α) — the
    distributed form of the paper's Eq. 1 max-stabilized softmax.  The
    port of the JAX package's ``shard_map`` body: each rank computes on
    its local blocks (``to_local``) and wraps the results back as
    DTensors.  The index stays a tensor (no host sync).
    """
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.sharding.rules import P, placements

    mesh = rules.mesh
    b, _, h, hd = q.shape
    S = cache_k.shape[1]
    hkv = cache_k.shape[2]
    shard = S // rules.model_size
    bsh = rules._bshard(b)
    qspec = P(bsh, None, None, None)
    kvspec = P(bsh, "model", None, None)

    def local(t, spec):
        pl = placements(spec, mesh)
        if isinstance(t, DTensor):
            return t.redistribute(mesh, pl).to_local()
        return distribute_tensor(t, mesh, pl).to_local()

    q_l, kn, vn = (local(t, qspec) for t in (q, k_new, v_new))
    k_l, v_l = local(cache_k, kvspec), local(cache_v, kvspec)
    idx_l = local(idx, P())
    group = mesh.get_group("model")
    lo = mesh.get_local_rank("model") * shard
    slot = idx_l - lo
    in_range = (slot >= 0) & (slot < shard)
    cl = torch.clamp(slot, 0, shard - 1)
    k_l = torch.where(in_range, dynamic_update_slice(
        k_l, kn.to(k_l.dtype), cl), k_l)
    v_l = torch.where(in_range, dynamic_update_slice(
        v_l, vn.to(v_l.dtype), cl), v_l)

    kk, vv = k_l.to(q_l.dtype), v_l.to(q_l.dtype)
    if hkv != h:
        kk = _expand_kv(kk, h)
        vv = _expand_kv(vv, h)
    scores = torch.einsum("bqhd,bkhd->bhqk", q_l, kk) / math.sqrt(hd)
    valid = (lo + torch.arange(shard, device=q_l.device)) < (idx_l + 1)
    scores = torch.where(valid[None, None, None, :], scores, -1e30)
    m = scores.amax(-1)                                        # (b,h,1)
    p = torch.exp(scores - m[..., None])
    l = p.sum(-1)                                              # (b,h,1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(vv.dtype), vv)
    # distributed Eq. 1 combine
    m_g = funcol.all_reduce(m, "max", group)
    alpha = torch.exp(m - m_g)
    l_g = funcol.all_reduce(l * alpha, "sum", group)
    o_g = funcol.all_reduce(
        o * alpha.transpose(1, 2)[..., None].to(o.dtype), "sum", group)
    out = o_g / l_g.clamp_min(1e-30).transpose(1, 2)[..., None].to(o.dtype)

    def wrap(t, spec):
        return DTensor.from_local(t, mesh, placements(spec, mesh),
                                  run_check=False)
    return (wrap(out.to(q_l.dtype), qspec), wrap(k_l, kvspec),
            wrap(v_l, kvspec))


def attention(p: dict, x: torch.Tensor, positions: torch.Tensor, cfg,
              *, causal: bool = True,
              kv_cache: Optional[dict] = None,
              cross_kv: Optional[tuple] = None
              ) -> tuple[torch.Tensor, Optional[dict]]:
    """Full attention layer (proj + rope + mha + out proj).

    kv_cache: {"k": (B, Smax, Hkv, hd), "v": ..., "index": int32 scalar
    tensor} for decode; returns the updated cache.  cross_kv: precomputed
    (k, v) for encoder-decoder cross attention.
    """
    b, s, d = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = shctx.constrain_heads(
        (x @ p["wq"].to(x.dtype)).reshape(b, s, h, hd), role="q")
    if cross_kv is None:
        k = shctx.constrain_heads(
            (x @ p["wk"].to(x.dtype)).reshape(b, s, hkv, hd), role="kv")
        v = shctx.constrain_heads(
            (x @ p["wv"].to(x.dtype)).reshape(b, s, hkv, hd), role="kv")
    else:
        k, v = cross_kv
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        if cross_kv is None:
            k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cross_kv is None:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)

    new_cache = None
    if kv_cache is not None:
        idx = kv_cache["index"]
        rules = shctx.get()
        S_cache = kv_cache["k"].shape[1]
        use_seqsharded = (
            s == 1 and rules is not None
            and getattr(rules, "mesh", None) is not None
            and cfg.sliding_window == 0
            and S_cache % rules.model_size == 0)
        if use_seqsharded:
            out, ck, cv = _flash_decode_seqsharded(
                q, kv_cache["k"], kv_cache["v"], k, v, idx, cfg, rules)
            new_cache = {"k": ck, "v": cv, "index": idx + s}
        else:
            # a sliding-window cache is a ring buffer over the window
            slot = idx % S_cache if cfg.sliding_window > 0 else idx
            ck = dynamic_update_slice(kv_cache["k"],
                                      k.to(kv_cache["k"].dtype), slot)
            cv = dynamic_update_slice(kv_cache["v"],
                                      v.to(kv_cache["v"].dtype), slot)
            new_cache = {"k": ck, "v": cv, "index": idx + s}
            k, v = ck.to(x.dtype), cv.to(x.dtype)
            kpos_valid = (torch.arange(S_cache, device=x.device)
                          < torch.clamp(idx + s, max=S_cache))
            if hasattr(kpos_valid, "to_local"):    # replicated: its value
                kpos_valid = kpos_valid.to_local()
            out = _on_shards(lambda q_, k_, v_, _: _decode_mha(
                q_, k_, v_, kpos_valid, hd, q_.shape[2], k_.shape[2]),
                q, k, v)
    else:
        if hkv != h:
            k = shctx.constrain_heads(_expand_kv(k, h), role="kv")
            v = shctx.constrain_heads(_expand_kv(v, h), role="kv")
        attend = mha_chunked if max(s, k.shape[1]) > _CHUNK_THRESHOLD \
            else mha
        out = _on_shards(lambda q_, k_, v_, off: attend(
            q_, k_, v_, causal=causal and cross_kv is None,
            window=cfg.sliding_window, q_offset=off), q, k, v)
    out = shctx.constrain_heads(out, role="q").reshape(b, s, h * hd)
    return shctx.constrain_resid(out @ p["wo"].to(x.dtype)), new_cache


def _decode_mha(q, k, v, kvalid, hd, h, hkv):
    """Single-token (or short-q) attention over a cache with validity mask."""
    if hkv != h:
        k = _expand_kv(k, h)
        v = _expand_kv(v, h)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    scores = scores.masked_fill(~kvalid[None, None, None, :], float("-inf"))
    m = scores.amax(-1, keepdim=True)
    ex = torch.exp(scores - m)
    probs = ex / ex.sum(-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def init_kv_cache(batch: int, max_len: int, cfg, dtype=torch.bfloat16, *,
                  device=None) -> dict:
    dev = resolve_device(device)
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    length = min(max_len, cfg.sliding_window) if cfg.sliding_window \
        else max_len
    shape = (batch, length, hkv, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "index": torch.zeros((), dtype=torch.int32, device=dev)}


# ---------------------------------------------------------------------------
# MLP / MoE
# ---------------------------------------------------------------------------

def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default


def _act(act: str):
    return F.silu if act == "silu" else _gelu_tanh


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, *, device=None,
             stack: tuple = ()) -> dict:
    s = 1.0 / math.sqrt(d_model)
    return {"w_gate": _normal(gen, stack + (d_model, d_ff), s, device),
            "w_up": _normal(gen, stack + (d_model, d_ff), s, device),
            "w_down": _normal(gen, stack + (d_ff, d_model),
                              1.0 / math.sqrt(d_ff), device)}


def mlp(p: dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    g = shctx.constrain_ff(_act(act)(x @ p["w_gate"].to(x.dtype)))
    u = shctx.constrain_ff(x @ p["w_up"].to(x.dtype))
    return shctx.constrain_resid((g * u) @ p["w_down"].to(x.dtype))


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             *, device=None, stack: tuple = ()) -> dict:
    s = 1.0 / math.sqrt(d_model)
    return {
        "router": _normal(gen, stack + (d_model, n_experts), s, device),
        "w_gate": _normal(gen, stack + (n_experts, d_model, d_ff), s, device),
        "w_up": _normal(gen, stack + (n_experts, d_model, d_ff), s, device),
        "w_down": _normal(gen, stack + (n_experts, d_ff, d_model),
                          1.0 / math.sqrt(d_ff), device),
    }


def _rowwise(fn, *ts):
    """``fn(*ts)`` on each rank's batch rows when ``ts[0]`` is a DTensor,
    else on the tensors themselves.

    For computations independent per batch row that DTensor has no
    strategy for (the MoE dispatch's sort, ``searchsorted``, scatter and
    ``index_add``): every DTensor argument is redistributed to the batch
    sharding of ``ts[0]`` and replicated otherwise, and every output
    (leading batch dim) comes back as a DTensor of that sharding.
    """
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(ts[0], DTensor):
        return fn(*ts)
    mesh = ts[0].device_mesh
    pl = tuple(q if q.is_shard(0) else Replicate()
               for q in ts[0].placements)
    outs = fn(*(t.redistribute(mesh, pl).to_local()
                if isinstance(t, DTensor) else t for t in ts))
    wrap = lambda t: DTensor.from_local(t, mesh, pl, run_check=False)
    return tuple(map(wrap, outs)) if isinstance(outs, tuple) else wrap(outs)


def _expert_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, E, C, K) x (E, K, N) -> (B, E, C, N), one product per expert.

    ``einsum`` on plain tensors; on DTensors the broadcasting ``matmul``
    (the same products), since the backward of DTensor's einsum here
    fails a view on its local blocks."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return torch.matmul(x, w)
    return torch.einsum("beck,ekn->becn", x, w)


def _log_sigmoid(x):
    """``F.logsigmoid``; on a DTensor, on each rank's block (DTensor has no
    strategy for it), a partial sum reduced first."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return F.logsigmoid(x)
    x = shctx.unshard(x)
    return DTensor.from_local(F.logsigmoid(x.to_local()), x.device_mesh,
                              x.placements, run_check=False)


def moe(p: dict, x: torch.Tensor, n_experts: int, top_k: int,
        act: str = "silu", capacity_factor: float = 1.25) -> torch.Tensor:
    """Top-k MoE: batch-local sorted dispatch + grouped expert GEMMs.

    Per-expert token counts are dynamically sized blocks packed into
    fixed-capacity expert slots; a token past its expert's capacity is
    dropped (its slot is the dump row, cut before the expert GEMMs).
    Each batch row dispatches only its own tokens: the JAX package's
    ``jax.vmap`` over rows is batched indexing here, and under a mesh the
    dispatch and the combine run on each rank's rows (``_rowwise``).
    """
    b, s, d = x.shape
    logits = x @ p["router"].to(x.dtype)                      # (B,S,E)
    capacity = max(1, int(capacity_factor * s * top_k / n_experts))
    n_slots = n_experts * capacity

    def dispatch(x, logits):
        b = x.shape[0]
        gates, idx = torch.topk(torch.softmax(logits, -1), top_k)  # (B,S,k)
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        flat_exp = idx.reshape(b, s * top_k)
        flat_tok = torch.arange(s, device=x.device).repeat_interleave(top_k)
        flat_gate = gates.reshape(b, s * top_k)
        order = torch.argsort(flat_exp, dim=-1, stable=True)
        sorted_exp = flat_exp.gather(1, order)
        sorted_tok = flat_tok[order]                          # (B,S*k)
        sorted_gate = flat_gate.gather(1, order)
        pos = torch.arange(s * top_k, device=x.device) - torch.searchsorted(
            sorted_exp, sorted_exp, side="left")
        keep = pos < capacity
        slot = torch.where(keep, sorted_exp * capacity + pos, n_slots)
        rows = torch.arange(b, device=x.device)[:, None]
        buf = x.new_zeros((b, n_slots + 1, d))
        # dropped tokens all write zeros into the dump row n_slots
        buf[rows, slot] = x[rows, sorted_tok] * keep[..., None].to(x.dtype)
        return buf[:, :-1], slot, sorted_tok, sorted_gate, keep

    buf, slot, sorted_tok, sorted_gate, keep = _rowwise(dispatch, x, logits)
    xe = shctx.constrain_expert(
        buf.reshape(b, n_experts, capacity, d))               # (B,E,C,d)

    a = _act(act)
    g = a(_expert_mm(xe, p["w_gate"].to(x.dtype)))
    u = _expert_mm(xe, p["w_up"].to(x.dtype))
    ye = _expert_mm(g * u, p["w_down"].to(x.dtype))

    def combine(ye, slot, sorted_tok, sorted_gate, keep):
        b = ye.shape[0]
        rows = torch.arange(b, device=ye.device)[:, None]
        ye_flat = ye.reshape(b, n_slots, d)
        picked = ye_flat[rows, torch.clamp(slot, max=n_slots - 1)]
        contrib = torch.where(keep[..., None], picked, 0.0) \
            * sorted_gate[..., None].to(ye.dtype)
        out = ye.new_zeros((b * s, d))
        out.index_add_(0, (rows * s + sorted_tok).reshape(-1),
                       contrib.reshape(-1, d))
        return out.reshape(b, s, d)

    return _rowwise(combine, ye, slot, sorted_tok, sorted_gate, keep)


# ---------------------------------------------------------------------------
# Mamba2 (chunked SSD) — the matmul-rich formulation
# ---------------------------------------------------------------------------

def init_mamba2(gen: torch.Generator, d_model: int, cfg, *, device=None,
                stack: tuple = ()) -> dict:
    d_inner = cfg.ssm_expand * d_model
    nheads = cfg.ssm_heads or max(1, d_inner // 64)
    n = cfg.ssm_state
    s = 1.0 / math.sqrt(d_model)
    dev = resolve_device(device)
    return {
        # in_proj -> [z, x, B, C, dt]
        "w_in": _normal(gen, stack + (d_model, 2 * d_inner + 2 * n + nheads),
                        s, device),
        "conv_w": _normal(gen, stack + (cfg.ssm_conv, d_inner + 2 * n), 0.1,
                          device),
        "A_log": torch.zeros(stack + (nheads,), device=dev),
        "D": torch.ones(stack + (nheads,), device=dev),
        "dt_bias": torch.zeros(stack + (nheads,), device=dev),
        "w_out": _normal(gen, stack + (d_inner, d_model),
                         1.0 / math.sqrt(d_inner), device),
        "norm": torch.ones(stack + (d_inner,), device=dev),
    }


def _mamba2_dims(p, cfg, d_model):
    d_inner = cfg.ssm_expand * d_model
    nheads = p["A_log"].shape[0]
    return d_inner, nheads, d_inner // nheads, cfg.ssm_state


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d: x (B,S,C), w (K,C)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = 0
    for i in range(k):
        out = out + xp[:, i:i + x.shape[1], :] * w[i]
    return out


def _carry_scan(sb: torch.Tensor, decay: torch.Tensor) -> torch.Tensor:
    """State before each chunk: ``carry = carry * decay_z + sb_z`` over the
    chunk axis z (axis 1), emitting the carry *before* chunk z."""
    carry = sb.new_zeros((sb.shape[0],) + sb.shape[2:])
    prev = []
    for z in range(sb.shape[1]):
        prev.append(carry)
        carry = carry * decay[:, z, :, None, None].to(carry.dtype) + sb[:, z]
    return torch.stack(prev, 1)


def mamba2(p: dict, x: torch.Tensor, cfg, chunk: int = 128) -> torch.Tensor:
    """Chunked SSD (Mamba-2): intra-chunk quadratic attention-like term +
    inter-chunk recurrent state carry — the matmul formulation of the
    selective state-space scan [arXiv:2405.21060]."""
    b, s, d_model = x.shape
    d_inner, h, hd, n = _mamba2_dims(p, cfg, d_model)
    proj = x @ p["w_in"].to(x.dtype)
    z, xs, Braw, Craw, dt = torch.split(
        proj, [d_inner, d_inner, n, n, proj.shape[-1] - 2 * d_inner - 2 * n],
        -1)
    conv_in = torch.cat([xs, Braw, Craw], -1)
    conv_out = F.silu(_causal_conv(conv_in, p["conv_w"].to(x.dtype)))
    xs, Braw, Craw = torch.split(conv_out, [d_inner, n, n], -1)
    dt = F.softplus(dt.float() + p["dt_bias"])               # (B,S,H)
    A = -torch.exp(p["A_log"])                                # (H,)
    # pad sequence to a multiple of the chunk
    c = chunk
    pad = (-s) % c
    if pad:
        xs, Braw, Craw, dt = (F.pad(t, (0, 0, 0, pad))
                              for t in (xs, Braw, Craw, dt))
    nc = xs.shape[1] // c
    X = xs.reshape(b, nc, c, h, hd)
    Bm = Braw.reshape(b, nc, c, n)
    Cm = Craw.reshape(b, nc, c, n)
    dt = dt.reshape(b, nc, c, h)

    dA = dt * A[None, None, None, :]                          # (B,NC,c,H)
    cum = torch.cumsum(dA, 2)
    # intra-chunk: L[i,j] = exp(cum_i - cum_j) for i >= j, causal
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # (B,NC,c,c,H)
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    L = torch.where(causal[None, None, :, :, None], torch.exp(li), 0.0)
    CB = torch.einsum("bzin,bzjn->bzij", Cm, Bm)              # (B,NC,c,c)
    M = CB[..., None] * L * dt[:, :, None, :, :]              # (B,NC,c,c,H)
    y_intra = torch.einsum("bzijh,bzjhp->bzihp", M.to(x.dtype), X)

    # chunk-final states: S_z = sum_j exp(cum_c - cum_j) dt_j B_j x_j^T
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)         # (B,NC,c,H)
    SB = shctx.constrain_state_matrix(torch.einsum(
        "bzjh,bzjn,bzjhp->bzhnp", (decay_to_end * dt).to(x.dtype), Bm, X))
    # inter-chunk scan over z
    chunk_decay = torch.exp(cum[:, :, -1, :])                 # (B,NC,H)
    prev_states = shctx.constrain_state_matrix(
        _carry_scan(SB, chunk_decay))                         # (B,NC,H,N,P)

    inter_decay = torch.exp(cum)                              # (B,NC,c,H)
    y_inter = torch.einsum("bzin,bzih,bzhnp->bzihp", Cm,
                           inter_decay.to(x.dtype), prev_states)
    y = (y_intra + y_inter).reshape(b, nc * c, h, hd)[:, :s]
    y = y + X.reshape(b, nc * c, h, hd)[:, :s] \
        * p["D"].to(x.dtype)[None, None, :, None]
    y = y.reshape(b, s, d_inner)
    # d_inner on model for the row-parallel w_out: the chunked einsums
    # leave y's sequence sharded, which DTensor cannot flatten into a GEMM
    y = shctx.constrain_ff(rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps))
    return y @ p["w_out"].to(x.dtype)


def init_mamba2_state(batch: int, p: dict, cfg, d_model: int,
                      dtype=torch.float32, *, device=None) -> dict:
    dev = resolve_device(device)
    d_inner, h, hd, n = _mamba2_dims(p, cfg, d_model)
    return {"ssm": torch.zeros((batch, h, n, hd), dtype=dtype, device=dev),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_inner + 2 * n),
                                dtype=dtype, device=dev)}


def mamba2_step(p: dict, x: torch.Tensor, state: dict, cfg
                ) -> tuple[torch.Tensor, dict]:
    """O(1) single-token decode update.  x: (B, 1, D)."""
    b, s, d_model = x.shape
    if s != 1:
        raise ValueError(f"mamba2_step takes one token, got {s}")
    d_inner, h, hd, n = _mamba2_dims(p, cfg, d_model)
    proj = x[:, 0] @ p["w_in"].to(x.dtype)
    z, xs, Braw, Craw, dt = torch.split(
        proj, [d_inner, d_inner, n, n, proj.shape[-1] - 2 * d_inner - 2 * n],
        -1)
    conv_in = torch.cat([xs, Braw, Craw], -1)                 # (B, C)
    window = torch.cat([state["conv"],
                        conv_in.to(state["conv"].dtype)[:, None]], 1)
    conv_out = F.silu(torch.einsum(
        "bkc,kc->bc", window, p["conv_w"].to(window.dtype))).to(x.dtype)
    new_conv = window[:, 1:]
    xs, Braw, Craw = torch.split(conv_out, [d_inner, n, n], -1)
    dt = F.softplus(dt.float() + p["dt_bias"])                # (B,H)
    A = -torch.exp(p["A_log"])
    da = torch.exp(dt * A[None, :])                           # (B,H)
    X = xs.reshape(b, h, hd)
    sd = state["ssm"].dtype
    new_ssm = (state["ssm"] * da[:, :, None, None].to(sd)
               + torch.einsum("bn,bh,bhp->bhnp", Braw.to(sd), dt.to(sd),
                              X.to(sd)))
    y = torch.einsum("bn,bhnp->bhp", Craw.to(new_ssm.dtype), new_ssm)
    y = y.to(x.dtype) + X * p["D"].to(x.dtype)[None, :, None]
    y = y.reshape(b, d_inner)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = (y @ p["w_out"].to(x.dtype))[:, None]
    return out, {"ssm": new_ssm, "conv": new_conv}


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory) + sLSTM (scalar memory)
# ---------------------------------------------------------------------------

def init_mlstm(gen: torch.Generator, d_model: int, cfg, *, device=None,
               stack: tuple = ()) -> dict:
    d_inner = cfg.ssm_expand * d_model
    h = cfg.n_heads
    s = 1.0 / math.sqrt(d_model)
    si = 1.0 / math.sqrt(d_inner)
    return {
        "w_up": _normal(gen, stack + (d_model, 2 * d_inner), s, device),
        "w_qkv": _normal(gen, stack + (d_inner, 3 * d_inner), si, device),
        "w_if": _normal(gen, stack + (d_inner, 2 * h), si, device),
        "w_down": _normal(gen, stack + (d_inner, d_model), si, device),
        "norm": torch.ones(stack + (d_inner,), device=resolve_device(device)),
    }


def mlstm(p: dict, x: torch.Tensor, cfg, chunk: int = 512) -> torch.Tensor:
    """Chunked parallel mLSTM: gated linear attention with matrix memory
    C_t = f_t C_{t-1} + i_t v_t k_t^T, y_t = C_t q_t (normalized)."""
    b, s, d_model = x.shape
    d_inner = cfg.ssm_expand * d_model
    h = cfg.n_heads
    hd = d_inner // h
    up = x @ p["w_up"].to(x.dtype)
    u, z = up.chunk(2, -1)
    u = shctx.constrain_ff(F.silu(u))       # (see mamba2's out projection)
    # d_inner whole on each rank: DTensor cannot split a sharded dim in 3
    qkv = shctx.unshard(u @ p["w_qkv"].to(x.dtype), -1)
    q, k, v = qkv.chunk(3, -1)
    # the gates whole on each rank (a partial sum over d_inner reduced)
    gates = shctx.unshard((u @ p["w_if"].to(x.dtype)).float(), -1)
    i_g, f_g = gates.chunk(2, -1)                             # (B,S,H)
    logf = _log_sigmoid(f_g)
    logi = i_g  # log-space input gate (exp applied with stabilizer)

    c = chunk
    pad = (-s) % c
    if pad:
        q, k, v, logf = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v, logf))
        logi = F.pad(logi, (0, 0, 0, pad), value=-30.)
    nc = q.shape[1] // c
    Q = q.reshape(b, nc, c, h, hd) / math.sqrt(hd)
    K = k.reshape(b, nc, c, h, hd)
    V = v.reshape(b, nc, c, h, hd)
    LF = logf.reshape(b, nc, c, h)
    LI = logi.reshape(b, nc, c, h)

    cumf = torch.cumsum(LF, 2)
    # stabilized intra-chunk weights: D[i,j] = exp(cumf_i - cumf_j + li_j)
    dmat = cumf[:, :, :, None, :] - cumf[:, :, None, :, :] \
        + LI[:, :, None, :, :]
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    dmat = dmat.masked_fill(~causal[None, None, :, :, None], float("-inf"))
    m_intra = dmat.amax(3, keepdim=True).clamp_min(-60.0)     # stabilizer
    D = torch.exp(dmat - m_intra)
    QK = torch.einsum("bzihd,bzjhd->bzijh", Q, K)
    W = QK * D.to(x.dtype)
    y_intra = torch.einsum("bzijh,bzjhd->bzihd", W, V)
    norm_intra = W.sum(3).abs()                               # (B,NC,c,H)

    # inter-chunk: states carried with decay
    dec_to_end = torch.exp(cumf[:, :, -1:, :] - cumf + LI)    # (B,NC,c,H)
    SB = shctx.constrain_state_matrix(torch.einsum(
        "bzjh,bzjhd,bzjhe->bzhde", dec_to_end.to(x.dtype), K, V))
    chunk_decay = torch.exp(cumf[:, :, -1, :])
    prev = shctx.constrain_state_matrix(
        _carry_scan(SB, chunk_decay))                         # (B,NC,H,hd,hd)
    dec_from_start = torch.exp(cumf)                          # (B,NC,c,H)
    y_inter = torch.einsum("bzihd,bzih,bzhde->bzihe", Q,
                           dec_from_start.to(x.dtype), prev)
    # normalizer uses the same stabilized accumulations (approx: intra term)
    y = (y_intra + y_inter) / norm_intra[..., None].to(x.dtype).clamp_min(1.0)
    y = y.reshape(b, nc * c, d_inner)[:, :s]
    y = shctx.constrain_ff(rms_norm(y, p["norm"], cfg.norm_eps)
                           * F.silu(z))    # (see mamba2's out projection)
    return y @ p["w_down"].to(x.dtype)


def init_mlstm_state(batch: int, d_model: int, cfg, dtype=torch.float32, *,
                     device=None) -> dict:
    dev = resolve_device(device)
    d_inner = cfg.ssm_expand * d_model
    h = cfg.n_heads
    hd = d_inner // h
    return {"C": torch.zeros((batch, h, hd, hd), dtype=dtype, device=dev),
            "n": torch.zeros((batch, h, hd), dtype=dtype, device=dev),
            "m": torch.full((batch, h), -30.0, device=dev)}


def mlstm_step(p: dict, x: torch.Tensor, state: dict, cfg
               ) -> tuple[torch.Tensor, dict]:
    """O(1) decode update with the stabilized mLSTM recurrence."""
    b, s, d_model = x.shape
    d_inner = cfg.ssm_expand * d_model
    h = cfg.n_heads
    hd = d_inner // h
    up = x[:, 0] @ p["w_up"].to(x.dtype)
    u, z = up.chunk(2, -1)
    u = F.silu(u)
    # d_inner whole on each rank: DTensor cannot split a sharded dim in 3
    qkv = shctx.unshard(u @ p["w_qkv"].to(x.dtype), -1)
    q, k, v = (t.reshape(b, h, hd) for t in qkv.chunk(3, -1))
    q = q / math.sqrt(hd)
    gates = (u @ p["w_if"].to(x.dtype)).float()
    i_g, f_g = gates.chunk(2, -1)                             # (B,H)
    logf = _log_sigmoid(f_g)
    m_new = torch.maximum(logf + state["m"], i_g)
    i_s = torch.exp(i_g - m_new)
    f_s = torch.exp(logf + state["m"] - m_new)
    cd, nd = state["C"].dtype, state["n"].dtype
    C = state["C"] * f_s[:, :, None, None].to(cd) \
        + i_s[:, :, None, None].to(cd) \
        * torch.einsum("bhd,bhe->bhde", v, k).to(cd)
    nvec = state["n"] * f_s[:, :, None].to(nd) \
        + i_s[:, :, None].to(nd) * k.to(nd)
    # hd whole on each rank before (h, hd) merge into d_inner
    num = shctx.unshard(torch.einsum("bhde,bhe->bhd", C, q.to(C.dtype)), -1)
    den = torch.einsum("bhd,bhd->bh", nvec, q.to(nvec.dtype)).abs() \
        .clamp_min(1.0)
    y = (num / den[:, :, None]).to(x.dtype).reshape(b, d_inner)
    y = rms_norm(y, p["norm"], cfg.norm_eps) * F.silu(z)
    out = (y @ p["w_down"].to(x.dtype))[:, None]
    return out, {"C": C, "n": nvec, "m": m_new}


def init_slstm(gen: torch.Generator, d_model: int, cfg, *, device=None,
               stack: tuple = ()) -> dict:
    s = 1.0 / math.sqrt(d_model)
    return {"w_gates": _normal(gen, stack + (d_model, 4 * d_model), s, device),
            "r_gates": _normal(gen, stack + (d_model, 4 * d_model), s * 0.1,
                               device),
            "w_out": _normal(gen, stack + (d_model, d_model), s, device),
            "norm": torch.ones(stack + (d_model,),
                               device=resolve_device(device))}


def _slstm_cell(g: torch.Tensor, c, n, m, dtype):
    """One sLSTM update from the gate pre-activations ``g`` (B, 4D)."""
    zi, zf, zo, zz = g.float().chunk(4, -1)
    logf = _log_sigmoid(zf)
    m_new = torch.maximum(logf + m, zi)
    i_s = torch.exp(zi - m_new)
    f_s = torch.exp(logf + m - m_new)
    c_new = f_s * c + i_s * torch.tanh(zz)
    n_new = f_s * n + i_s
    h_new = (torch.sigmoid(zo) * c_new / n_new.abs().clamp_min(1.0)).to(dtype)
    return c_new, n_new, m_new, h_new


def slstm(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Sequential sLSTM (scalar memory, exponential gating): a loop over
    the sequence (the JAX package's ``lax.scan``)."""
    b, s, d = x.shape
    wx = x @ p["w_gates"].to(x.dtype)                         # (B,S,4D)
    r = p["r_gates"].to(x.dtype)
    c = torch.zeros((b, d), device=x.device)
    n = torch.zeros((b, d), device=x.device)
    m = torch.full((b, d), -30.0, device=x.device)
    hprev = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    hs = []
    for t in range(s):
        c, n, m, hprev = _slstm_cell(wx[:, t] + hprev @ r, c, n, m, x.dtype)
        hs.append(hprev)
    y = torch.stack(hs, 1)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    return y @ p["w_out"].to(x.dtype)


def init_slstm_state(batch: int, d_model: int, dtype=torch.float32, *,
                     device=None) -> dict:
    dev = resolve_device(device)
    return {"c": torch.zeros((batch, d_model), device=dev),
            "n": torch.zeros((batch, d_model), device=dev),
            "m": torch.full((batch, d_model), -30.0, device=dev),
            "h": torch.zeros((batch, d_model), dtype=dtype, device=dev)}


def slstm_step(p: dict, x: torch.Tensor, state: dict, cfg
               ) -> tuple[torch.Tensor, dict]:
    wx = x[:, 0] @ p["w_gates"].to(x.dtype)
    g = wx + state["h"].to(x.dtype) @ p["r_gates"].to(x.dtype)
    c_new, n_new, m_new, h_new = _slstm_cell(g, state["c"], state["n"],
                                             state["m"], x.dtype)
    y = rms_norm(h_new, p["norm"], cfg.norm_eps)
    out = (y @ p["w_out"].to(x.dtype))[:, None]
    return out, {"c": c_new, "n": n_new, "m": m_new, "h": h_new}
