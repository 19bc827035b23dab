"""AdamW with global-norm clipping and optional int8 gradient compression.

The port of ``repro.train.optimizer``.  Self-contained: state = {m, v,
step}, trees are nested dicts of tensors (``repro_torch.tree``).  The
compression hook (``compress_grads`` / ``decompress_grads``) is the JAX
package's error-feedback int8 quantization for a cross-pod all-reduce.

Roundings follow the JAX package's: ``b1 ** step`` and ``lr * warm`` are
float32, the global norm sums the leaves in ``jax.tree.leaves`` order,
and the warm-up divides the step as jitted XLA does (times the float32
reciprocal of ``warmup_steps``; the JAX package trains under
``jax.jit``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100


def init_opt_state(params: Any) -> dict:
    """float32 ``m`` / ``v`` like ``params`` and a 0-d int32 ``step``, on
    the parameters' device."""
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params),
            "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    inv = float(np.float32(1) / np.float32(max(cfg.warmup_steps, 1)))
    warm = torch.clamp(step.float() * inv, max=1.0)
    return cfg.lr * warm


def _prelude(cfg: OptimizerConfig, grads: Any, state: dict) -> tuple:
    """The step's scalars: the new ``step``, the global norm, the clip
    scale, ``lr`` and the two bias corrections, all on the device."""
    step = state["step"] + 1
    # global-norm clip
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in tree_leaves(grads)))
    scale = torch.clamp(torch.full_like(gnorm, cfg.clip_norm)
                        / torch.clamp_min(gnorm, 1e-9), max=1.0)
    lr = _schedule(cfg, step)
    step_f = step.float()
    bc1 = 1 - torch.full_like(step_f, cfg.beta1) ** step_f
    bc2 = 1 - torch.full_like(step_f, cfg.beta2) ** step_f
    return step, gnorm, scale, lr, bc1, bc2


def _leaf(cfg: OptimizerConfig, p, g, m, v, scale, lr, bc1, bc2) -> tuple:
    """One leaf's new (p, m, v)."""
    b1, b2 = cfg.beta1, cfg.beta2
    g = g.float() * scale
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * torch.square(g)
    mh = m / bc1
    vh = v / bc2
    delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
    return p - (lr * delta).to(p.dtype), m, v


def adamw_update(cfg: OptimizerConfig, params: Any, grads: Any,
                 state: dict) -> tuple[Any, dict, dict]:
    """One AdamW step -> (new params, new state, {grad_norm, lr}).

    The inputs are left as they are; every value stays on the device
    (no host sync).  ``grad_norm`` is the norm before clipping.
    """
    step, gnorm, scale, lr, bc1, bc2 = _prelude(cfg, grads, state)
    out = tree_map(lambda p, g, m, v: _leaf(cfg, p, g, m, v, scale, lr,
                                            bc1, bc2),
                   params, grads, state["m"], state["v"])
    new_params, new_m, new_v = (tree_map(lambda t: t[i], out)
                                for i in range(3))
    return (new_params, {"m": new_m, "v": new_v, "step": step},
            {"grad_norm": gnorm, "lr": lr})


def adamw_update_(cfg: OptimizerConfig, params: Any, grads: Any,
                  state: dict) -> dict:
    """``adamw_update`` in place: each leaf's new ``p``, ``m`` and ``v``
    (the same arithmetic, ``_leaf``) are copied into ``params`` and
    ``state`` before the next leaf is computed, so a second tree of
    parameters and moments never exists whole; ``state["step"]`` is
    advanced on the device.  Returns {grad_norm, lr}."""
    step, gnorm, scale, lr, bc1, bc2 = _prelude(cfg, grads, state)
    for p, g, m, v in zip(*map(tree_leaves, (params, grads, state["m"],
                                             state["v"]))):
        for dst, src in zip((p, m, v),
                            _leaf(cfg, p, g, m, v, scale, lr, bc1, bc2)):
            dst.copy_(src)
    state["step"].copy_(step)
    return {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# int8 gradient compression (error feedback) for cross-pod reduction
# ---------------------------------------------------------------------------

def compress_grads(grads: Any) -> Any:
    """Symmetric per-leaf int8 quantization -> {"q", "scale"} per leaf.

    ``q`` and ``scale`` equal the JAX package's (called eagerly, as its
    callers do) bit for bit on every device: true divisions, rounding
    half to even.  Dividing a CUDA tensor by a Python number multiplies
    by its reciprocal instead, so the divisor is a tensor.
    """
    def comp(g):
        a = g.abs().amax().float()
        scale = a.clamp_min(1e-12) / torch.full((), 127.0, device=g.device)
        q = torch.round(g.float() / scale).clamp(-127, 127) \
            .to(torch.int8)
        return {"q": q, "scale": scale}
    return tree_map(comp, grads)


def decompress_grads(comp: Any) -> Any:
    if isinstance(comp, dict) and "q" not in comp:
        return {k: decompress_grads(v) for k, v in comp.items()}
    return comp["q"].float() * comp["scale"]
