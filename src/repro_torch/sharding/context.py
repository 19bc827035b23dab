"""Ambient sharding context for activation constraints inside layers.

The port of ``repro.sharding.context``.  Model code is mesh-agnostic;
when the launcher runs under a device mesh it installs the resolved
``ShardingRules`` here, and the layer library constrains activations at
the points where the JAX package applies ``with_sharding_constraint``
(head-split reshapes, MoE dispatch buffers, chunked recurrent states).
On a DTensor a constraint is ``redistribute`` to the spec's placements
(the collectives it needs are the program's); without rules, or on a
plain tensor, every constraint returns its input itself, so single-device
runs are unaffected.
"""

from __future__ import annotations

import contextlib

from .rules import P, placements

_ACTIVE: list = []


@contextlib.contextmanager
def use_rules(rules):
    """Install ``rules`` for the layers.  While they are active, a plain
    tensor that meets a DTensor in an op (the masks and positions the
    layers build) is taken as replicated on the DTensor's mesh."""
    from torch.distributed.tensor.experimental import implicit_replication
    _ACTIVE.append(rules)
    try:
        with implicit_replication():
            yield
    finally:
        _ACTIVE.pop()


def get():
    return _ACTIVE[-1] if _ACTIVE else None


def constrain(x, spec: P):
    """``x`` redistributed to ``spec`` on its own mesh; a plain tensor (no
    mesh) is left unconstrained (``jax.lax.with_sharding_constraint``)."""
    return _wsc(x, spec)


def unshard(x, *dims: int):
    """``x`` with ``dims`` whole on every rank and any partial sum reduced,
    its other placements kept, where DTensor has no strategy for an op
    over a sharded dim; a plain tensor is returned as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x
    dims = {d % x.ndim for d in dims}
    keep = tuple(Replicate() if pl.is_partial()
                 or (pl.is_shard() and pl.dim in dims) else pl
                 for pl in x.placements)
    return x.redistribute(x.device_mesh, keep)


def local_block(x, dim: int) -> tuple[int, int, list]:
    """This rank's block of dim ``dim`` of the DTensor ``x``: its first
    index, its length, and the mesh dims that shard it (outermost
    first).  The dim must split evenly."""
    mesh = x.device_mesh
    axes = [i for i, pl in enumerate(x.placements) if pl.is_shard(dim)]
    block, coord = x.shape[dim], 0
    for i in axes:
        block //= mesh.size(i)
        coord = coord * mesh.size(i) + mesh.get_local_rank(i)
    return coord * block, block, axes


def _wsc(x, spec: P):
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    return x.redistribute(mesh, placements(spec, mesh, x.shape))


def constrain_heads(x, role: str = "q"):
    """(B, S, H, hd) activations: heads on model when divisible.

    Fallback: when the head count does not divide the model axis (phi3
    40H, granite-moe 24H, xlstm 4H), ``q`` shards the SEQUENCE dim on
    model instead — context-parallel attention: each model shard computes
    scores for S/16 query rows against the full (replicated) K/V.  Decode
    (S=1) cannot seq-shard and stays replicated.
    """
    r = get()
    if r is None:
        return x
    if x.shape[2] % r.model_size == 0:
        return _wsc(x, P(r.batch, None, "model", None))
    if role == "q" and x.shape[1] % r.model_size == 0:
        return _wsc(x, P(r.batch, "model", None, None))
    return _wsc(x, P(r.batch, None, None, None))


def constrain_ff(x):
    """(B, S, F) hidden activations: F on model when divisible."""
    r = get()
    if r is None:
        return x
    f_ax = "model" if x.shape[-1] % r.model_size == 0 else None
    return _wsc(x, P(r.batch, None, f_ax))


def constrain_resid(x):
    """(B, S, D) residual-stream activations: batch-sharded, D replicated."""
    r = get()
    if r is None:
        return x
    return _wsc(x, P(r.batch, None, None))


def constrain_expert(x):
    """(B, E, cap, D) MoE dispatch buffers: batch on data axis."""
    r = get()
    if r is None:
        return x
    b_ax = r.batch if x.shape[0] % r.data_size == 0 else None
    return _wsc(x, P(b_ax, None, None, None))


def constrain_state_matrix(x):
    """(B, NC, H, d, e) chunked recurrent states (mLSTM C / Mamba2 SSD):
    batch on data, first state dim on model when divisible — this keeps
    xLSTM's (hd x hd) matrix memory from filling device memory."""
    r = get()
    if r is None:
        return x
    b_ax = r.batch if x.shape[0] % r.data_size == 0 else None
    d_ax = "model" if x.shape[-2] % r.model_size == 0 else None
    lead = [None] * (x.ndim - 4)
    return _wsc(x, P(b_ax, *lead, None, d_ax, None))
