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

``compile_train_step`` is the counterpart of the JAX training entry
points' ``jax.jit(make_train_step(...))``: on a CUDA device it captures
the step once per key (``train_key``: the batch, params and optimizer
state trees' leaf paths, shapes and dtypes) as a CUDA graph
(``TrainExecutable``) that updates its own parameters and optimizer
state in place, at the key's second call (its first is the eager step),
and replays it for every later step; on the CPU it is the eager step.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.sharding import context as shctx
from repro_torch.tree import (tree_from_items, tree_items, tree_leaves,
                              tree_map)

from .optimizer import OptimizerConfig, adamw_update, adamw_update_


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


def make_inplace_train_step(cfg: ModelConfig,
                            opt_cfg: OptimizerConfig = OptimizerConfig(),
                            microbatches: int = 1, remat: bool = True,
                            logits_spec=None):
    """``make_train_step`` that writes the new parameters and optimizer
    state into the trees it is given (``adamw_update_``, leaf by leaf)
    and returns only the metrics: the function a ``TrainExecutable``
    captures.  Its results equal ``make_train_step``'s bit for bit."""
    grad_fn = make_grad_fn(cfg, microbatches, remat, logits_spec)

    def train_step_(params, opt_state, batch):
        loss, grads = grad_fn(params, batch)
        metrics = adamw_update_(opt_cfg, params, grads, opt_state)
        metrics["loss"] = loss
        return metrics

    return train_step_


def train_key(params, opt_state, batch) -> tuple:
    """The key of a train call's executable: each leaf's (path, shape,
    dtype) of the batch, the parameters and the optimizer state.  No
    address: the executable copies in any tree that is not its own."""
    return tuple(tuple((p, tuple(t.shape), t.dtype) for p, t in
                       tree_items(tree))
                 for tree in (batch, params, opt_state))


def _copy_in(dst_tree, src_tree) -> None:
    """Copy each leaf of ``src_tree`` that is not ``dst_tree``'s own."""
    for dst, src in zip(tree_leaves(dst_tree), tree_leaves(src_tree)):
        if src is not dst:
            dst.copy_(src)


@dataclasses.dataclass
class TrainExecutable:
    """The train step on one key, captured as a CUDA graph.

    ``params`` and ``opt_state`` (``m``, ``v`` and the 0-d int32
    ``step``) are the trees the eager first step of the key returned;
    they become the graph's static state.  ``capture`` records the
    in-place step on them and on a static ``batch``: the graph writes the
    new parameters and state back into ``params`` and ``opt_state`` leaf
    by leaf (``make_inplace_train_step``) and the 0-d ``loss``,
    ``grad_norm`` and ``lr`` into ``metrics``.  The learning-rate
    schedule and the bias corrections read ``step`` on the device, so
    they advance inside the graph.  ``graph``, ``batch`` and ``metrics``
    are None until the capture; ``capture_s`` is its host seconds.
    """

    params: dict
    opt_state: dict
    pool: tuple
    graph: Any = None
    batch: Optional[dict] = None
    metrics: Optional[dict] = None
    capture_s: float = 0.0

    def capture(self, step_, batch) -> None:
        """Capture ``step_`` on the static state and a copy of ``batch``
        into ``pool`` (a capture runs nothing).  ``torch.cuda.graph``
        first releases the cached blocks, so the pool holds the step's
        gradients and activations beside the one static state tree."""
        t0 = time.perf_counter()
        with torch.cuda.device(tree_leaves(self.params)[0].device):
            self.batch = tree_map(torch.clone, batch)
            graph = torch.cuda.CUDAGraph()
            # "thread_local" refuses an unsafe CUDA call on this thread
            # only: the backward runs on the autograd engine's device
            # thread, whose launches on the capture stream are recorded
            with torch.cuda.graph(graph, pool=self.pool,
                                  capture_error_mode="thread_local"):
                self.metrics = step_(self.params, self.opt_state,
                                     self.batch)
        self.graph = graph
        self.capture_s = time.perf_counter() - t0

    def __call__(self, params, opt_state, batch):
        """One step by a replay: ``(params, opt_state, metrics)``.

        The batch is copied in; the parameters and optimizer state only
        where they are not this executable's own tensors, so a loop that
        passes back what it was given copies nothing.  The metrics are
        new tensors; ``params`` and ``opt_state`` are this executable's
        own trees, which its next call overwrites.
        """
        _copy_in(self.batch, batch)
        _copy_in(self.params, params)
        _copy_in(self.opt_state, opt_state)
        self.graph.replay()
        return (self.params, self.opt_state,
                {k: v.clone() for k, v in self.metrics.items()})


class CompiledTrainStep:
    """``make_train_step(cfg, opt_cfg, microbatches, remat, logits_spec)``
    with one executable per key, the counterpart of ``jax.jit`` of the
    step.

    Called as the step is, ``(params, opt_state, batch) -> (params,
    opt_state, metrics)``.  On a CUDA device the first call of a key
    (``train_key``) is the eager step, whose new trees become the state
    of a ``TrainExecutable`` in ``executables`` (all of them in one
    memory pool); the second call captures the in-place step on that
    state, and it and every later call replay the key's graph.  So no
    capture holds the caller's first tree beside the static one, and the
    first call's peak is the eager step's.  The trees it returns are the
    executable's own buffers: the next call of that key overwrites them
    (pass them back, as a training loop does, and nothing is copied; a
    tree from elsewhere, such as a restored checkpoint, is copied in);
    the metrics are fresh tensors.  A capture that fails raises: nothing
    carries on eagerly on the card.  Under a sharding context with a
    mesh it raises (the eager ``make_train_step`` trains there).  On the
    CPU it is the eager step, and ``executables`` stays empty.
    """

    def __init__(self, cfg: ModelConfig,
                 opt_cfg: OptimizerConfig = OptimizerConfig(),
                 microbatches: int = 1, remat: bool = True,
                 logits_spec=None):
        args = (cfg, opt_cfg, microbatches, remat, logits_spec)
        self.step = make_train_step(*args)
        self.step_ = make_inplace_train_step(*args)
        self.executables: dict[tuple, TrainExecutable] = {}

    def __call__(self, params, opt_state, batch):
        if not self._captures(tree_leaves(params)[0].device):
            return self.step(params, opt_state, batch)
        if getattr(shctx.get(), "mesh", None) is not None:
            raise RuntimeError(
                "compile_train_step does not capture under a device mesh "
                "(the sharded step runs collectives); train with "
                "make_train_step there")
        key = train_key(params, opt_state, batch)
        exe = self.executables.get(key)
        if exe is None:
            params, opt_state, metrics = self.step(params, opt_state, batch)
            pool = (next(iter(self.executables.values())).pool
                    if self.executables else self._pool())
            self.executables[key] = TrainExecutable(params, opt_state, pool)
            return params, opt_state, metrics
        if exe.graph is None:
            self._capture(exe, batch)
        return exe(params, opt_state, batch)

    def _captures(self, device: torch.device) -> bool:
        return device.type == "cuda"

    def _pool(self) -> tuple:
        return torch.cuda.graph_pool_handle()

    def _capture(self, exe: TrainExecutable, batch) -> None:
        exe.capture(self.step_, batch)


def compile_train_step(cfg: ModelConfig,
                       opt_cfg: OptimizerConfig = OptimizerConfig(),
                       microbatches: int = 1, remat: bool = True,
                       logits_spec=None) -> CompiledTrainStep:
    """The train step compiled as the JAX training entry points jit it:
    one CUDA graph per key on the card, the eager step on the CPU (see
    ``CompiledTrainStep``)."""
    return CompiledTrainStep(cfg, opt_cfg, microbatches, remat, logits_spec)
