"""Training step factory: loss + grad + AdamW, remat and microbatching.

The port of ``repro.train.step``.  ``make_train_step(cfg, opt_cfg, ...)``
returns a function ``(params, opt_state, batch) -> (params, opt_state,
metrics)`` that leaves its inputs as they are, as the JAX package's pure
step does.  Gradients come from ``torch.autograd`` over the float
parameters; the forward computes in bfloat16, as ``make_loss_fn`` fixes
it in the JAX package, and the parameters keep their dtype.

Microbatching (grad accumulation) runs the forward/backward over
``microbatches`` slices of the batch in turn (the JAX package's
``lax.scan``), summing float32 gradients and dividing by the count.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.sharding import context as shctx
from repro_torch.tree import tree_from_items, tree_items, tree_map

from .optimizer import OptimizerConfig, adamw_update


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int) -> torch.Tensor:
    """Mean CE over tokens; logits in any dtype, reduction in f32.

    The logsumexp runs over every column, the vocabulary's padding
    included.  Labels < 0 or >= vocab_size (padding ids) are masked out.
    """
    lf = logits.float()
    lse = torch.logsumexp(lf, -1)
    mask = (labels >= 0) & (labels < vocab_size)
    # torch.gather needs int64 ids inside the row: clamp the masked ones
    ids = labels.long().clamp(0, lf.shape[-1] - 1)
    gold = _gold(lf, ids)
    # per-token losses whole on each rank (a few KB): the mean's backward
    # over sharded (batch, seq) losses fails a view in DTensor
    loss = shctx.unshard(torch.where(mask, lse - gold, 0.0), 0, 1)
    mask = shctx.unshard(mask, 0, 1)
    return loss.sum() / mask.sum().clamp_min(1)


def _gold(lf: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``lf.gather(-1, ids[..., None])[..., 0]``.

    On a DTensor whose vocabulary (last dim) is sharded, each rank gathers
    the ids that fall in its own block of columns and zero for the rest,
    and the result is the sum over the vocab axis's ranks (a ``Partial``
    DTensor, reduced where it is next used): DTensor's own gather there
    fails to mask its partial result.
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(lf, DTensor):
        return lf.gather(-1, ids[..., None])[..., 0]
    mesh, last = lf.device_mesh, lf.ndim - 1
    lf = shctx.unshard(lf).contiguous()       # a partial sum reduced
    lo, block, vocab_axes = shctx.local_block(lf, last)
    rows = tuple(Replicate() if i in vocab_axes else pl
                 for i, pl in enumerate(lf.placements))
    local = ids.redistribute(mesh, rows).to_local() - lo
    inside = (local >= 0) & (local < block)
    g = lf.to_local().gather(-1, local.clamp(0, block - 1)[..., None])[..., 0]
    g = torch.where(inside, g, 0.0)
    return DTensor.from_local(
        g, mesh, tuple(Partial() if i in vocab_axes else pl
                       for i, pl in enumerate(rows)), run_check=False)


def make_loss_fn(cfg: ModelConfig, remat: bool = True, logits_spec=None):
    """``loss_fn(params, batch)``: next-token cross entropy of
    ``batch["tokens"]`` (Whisper also reads ``batch["frames"]``).

    ``logits_spec`` (a ``sharding.rules.P``) constrains the logits under
    a device mesh (``sharding.context.constrain``); on plain tensors it
    changes nothing.
    """
    def loss_fn(params, batch):
        logits = lm.forward(params, cfg, batch["tokens"],
                            encoder_input=batch.get("frames"),
                            remat=remat)
        if logits_spec is not None:
            logits = shctx.constrain(logits, logits_spec)
        return cross_entropy(logits[:, :-1], batch["tokens"][:, 1:],
                             cfg.vocab_size)
    return loss_fn


def _value_and_grad(loss_fn: Callable) -> Callable:
    """``(params, batch) -> (loss, grads)``, ``jax.value_and_grad`` of
    ``loss_fn``: a parameter the loss never reads gets a zero gradient."""
    def vg(params, batch):
        keys, leaves = zip(*[(k, p.detach().requires_grad_())
                             for k, p in tree_items(params)])
        with torch.enable_grad():
            loss = loss_fn(tree_from_items(params, dict(zip(keys, leaves))),
                           batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), tree_from_items(params,
                                              dict(zip(keys, grads)))
    return vg


def make_grad_fn(cfg: ModelConfig, microbatches: int = 1,
                 remat: bool = True, logits_spec=None) -> Callable:
    """``(params, batch) -> (loss, grads)``: the train step before its
    optimizer update, microbatches accumulated."""
    grad_fn = _value_and_grad(make_loss_fn(cfg, remat, logits_spec))
    if microbatches <= 1:
        return grad_fn
    # the mean as jitted XLA computes it: times the float32 reciprocal
    inv = float(np.float32(1) / np.float32(microbatches))

    def accumulated(params, batch):
        micro = tree_map(lambda x: _split_batch(x, microbatches), batch)
        gsum, lsum = None, 0.0
        for i in range(microbatches):
            loss_i, g_i = grad_fn(params, tree_map(lambda x: x[i], micro))
            gsum = (tree_map(lambda g: g.float(), g_i) if gsum is None
                    else tree_map(torch.add, gsum, g_i))
            lsum = lsum + loss_i
        return lsum * inv, tree_map(lambda g: g * inv, gsum)
    return accumulated


def _split_batch(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x``'s batch cut into ``n`` microbatches of contiguous rows
    (``(n, B // n, ...)``).  On a DTensor the batch is gathered, cut and
    each microbatch sharded over the batch's mesh dims as the batch was:
    DTensor cannot cut a dim sharded 16 ways into 8 blocks."""
    from torch.distributed.tensor import DTensor, Shard
    b = x.shape[0]
    if not isinstance(x, DTensor):
        return x.reshape(n, b // n, *x.shape[1:])
    pl = tuple(Shard(1) if p.is_shard(0) else p for p in x.placements)
    whole = shctx.unshard(x, 0)
    return whole.reshape(n, b // n, *x.shape[1:]).redistribute(
        x.device_mesh, pl)


def make_train_step(cfg: ModelConfig,
                    opt_cfg: OptimizerConfig = OptimizerConfig(),
                    microbatches: int = 1, remat: bool = True,
                    logits_spec=None):
    """The step: metrics ``loss``, ``grad_norm`` and ``lr`` are 0-d
    tensors on the parameters' device; the step makes no host sync."""
    grad_fn = make_grad_fn(cfg, microbatches, remat, logits_spec)

    def train_step(params, opt_state, batch):
        loss, grads = grad_fn(params, batch)
        new_params, new_state, metrics = adamw_update(opt_cfg, params,
                                                      grads, opt_state)
        metrics["loss"] = loss
        return new_params, new_state, metrics

    return train_step
