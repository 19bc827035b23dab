"""Logical sharding rules: parameter/activation partition specs per
architecture.

The port of ``repro.sharding.rules``, decision for decision.  Mesh axes:

  single-pod : ("data", "model") = (16, 16)
  multi-pod  : ("pod", "data", "model") = (2, 16, 16) — "pod" extends the
               data-parallel dimension (batch + FSDP weight sharding).

Rules (resolved per arch):
  * d_model rows of big weights -> "data" (ZeRO/FSDP)
  * attention head dims -> "model" when n_(kv_)heads divides the model
    axis; otherwise the contracting d_model dim goes on "model" (phi3
    40H, granite-moe 24H, xlstm 4H)
  * d_ff / d_inner -> "model" (Megatron column/row pattern)
  * vocab -> "model" (padded to 256, see ModelConfig.padded_vocab)
  * MoE experts -> replicated (each expert TP-sharded on d_ff)
  * decode KV caches: batch -> "data" when divisible; cache seq ->
    "model" (the sequence-sharded flash decode of ``models.layers``)

A spec is a ``P``: one entry per tensor dim, each ``None``
(replicated), a mesh axis name, or a tuple of names (the dim split over
those axes, the first outermost), as in ``jax.sharding.PartitionSpec``.
``placements`` turns a spec into DTensor placements on a
``DeviceMesh`` whose dims carry the axis names.
"""

from __future__ import annotations

import math
from typing import Any

from repro_torch.configs.base import ModelConfig
from repro_torch.tree import tree_map


class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"), None)``.
    A one-name tuple entry is the name itself, as in ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def placements(spec: P, mesh, shape=None) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(dim)`` on each
    mesh dim the spec names, ``Replicate()`` on the others.  Given the
    tensor's ``shape``, a dim that its axes' sizes do not divide stays
    whole (replicated) where GSPMD would pad it (``long_500k``'s batch of
    1 under ``constrain_resid``).

    A dim split over several axes (``("pod", "data")``) is sharded on
    each of their mesh dims in mesh order, which gives a rank the block
    ``pod_index * data_size + data_index`` of the dim, the row-major
    block JAX's named sharding gives it.
    """
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    whole = set()
    if shape is not None:
        for d, e in enumerate(spec):
            axes = e if isinstance(e, tuple) else (e,)
            n = math.prod(mesh.size(names.index(a)) for a in axes
                          if a is not None)
            if shape[d] % n:
                whole.add(d)
    out = []
    for name in names:
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        if len(dims) > 1:
            raise ValueError(f"{spec} names mesh axis {name!r} twice")
        out.append(Shard(dims[0]) if dims and dims[0] not in whole
                   else Replicate())
    return tuple(out)


def batch_axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else ("data",)


def _div(n: int, size: int) -> bool:
    return n > 0 and n % size == 0


class ShardingRules:
    """Resolves partition specs for one (config, mesh) pair."""

    def __init__(self, cfg: ModelConfig, *, model_size: int = 16,
                 data_size: int = 16, multi_pod: bool = False):
        self.cfg = cfg
        self.model = "model"
        self.data = "data"
        self.model_size = model_size
        self.data_size = data_size
        self.multi_pod = multi_pod
        self.batch = batch_axes(multi_pod)
        self.mesh = None           # set by the launcher: the decode's mesh
        c = cfg
        self.heads_shardable = _div(c.n_heads, model_size)
        self.kv_shardable = _div(c.n_kv_heads, model_size)
        self.ff_shardable = _div(c.d_ff, model_size)
        self.dmodel_shardable = _div(c.d_model, data_size)
        d_inner = c.ssm_expand * c.d_model
        self.dinner_shardable = _div(d_inner, model_size)

    # -- parameter specs ------------------------------------------------------
    def _leaf_spec(self, path: tuple[str, ...], leaf) -> P:
        name = path[-1]
        rank = leaf.ndim
        c = self.cfg
        dm = self.data if self.dmodel_shardable else None
        mh = self.model if self.heads_shardable else None
        mkv = self.model if self.kv_shardable else None
        mf = self.model if self.ff_shardable else None
        mi = self.model if self.dinner_shardable else None

        def lead(spec: tuple) -> P:
            """Pad leading stacked-layer/group axes with None."""
            return P(*([None] * (rank - len(spec)) + list(spec)))

        if name == "embed":
            return P(self.model if _div(c.padded_vocab, self.model_size)
                     else None, dm)
        if name == "lm_head":
            return P(dm, self.model)
        if name in ("wq", "wk", "wv", "wo"):
            # heads shardable: Megatron head-dim TP.  Otherwise shard the
            # CONTRACTING d_model dim on model: partial projections and a
            # small all-reduce beat 16x replicated GEMMs.
            if name == "wo":
                if self.heads_shardable:
                    return lead((mh, dm))
                return lead((self.model if _div(leaf.shape[-2],
                                                self.model_size) else None,
                             None))
            shardable = self.heads_shardable if name == "wq" \
                else self.kv_shardable
            if shardable:
                return lead((dm, mh if name == "wq" else mkv))
            return lead((self.model if _div(c.d_model, self.model_size)
                         else None, None))
        if name == "router":
            return lead((dm, None))
        if name in ("w_gate", "w_up"):        # mlp (D,F) or moe (E,D,F)
            return lead((dm, mf))
        if name == "w_down":                  # (F,D) or (E,F,D)
            return lead((mf, dm))
        if name == "w_in":                    # mamba (D, X) — X mixed split
            return lead((dm, None))
        if name == "w_out":                   # mamba/mlstm (d_inner, D)
            return lead((mi, dm))
        if name == "w_qkv":                   # mlstm (d_inner, 3*d_inner)
            return lead((None, mi))
        if name == "w_if":
            return lead((None, None))
        if name == "w_gates" or name == "r_gates":   # slstm (D, 4D)
            return lead((dm, mi if _div(4 * c.d_model, self.model_size)
                         else None))
        # norms, biases, conv weights, scalars: replicated
        return P(*([None] * rank))

    def param_specs(self, params: Any):
        """The spec of every leaf of ``params`` (``lm.init_params``'s
        tree, or any tree of objects with ``ndim`` and ``shape``)."""
        return _map_with_path(self._leaf_spec, params)

    # -- activation / data specs ----------------------------------------------
    def _bshard(self, batch: int):
        """Batch axis spec, falling back to replication when indivisible
        (e.g. long_500k's global_batch=1)."""
        need = self.data_size * (2 if self.multi_pod else 1)
        return self.batch if _div(batch, need) else None

    def tokens_spec(self, batch: int = 0) -> P:
        b = self._bshard(batch) if batch else self.batch
        return P(b, None)

    def logits_spec(self, batch: int = 0) -> P:
        b = self._bshard(batch) if batch else self.batch
        return P(b, None,
                 self.model if _div(self.cfg.padded_vocab, self.model_size)
                 else None)

    def encoder_spec(self, batch: int = 0) -> P:
        b = self._bshard(batch) if batch else self.batch
        return P(b, None, None)

    # -- decode cache specs -----------------------------------------------------
    def cache_specs(self, caches: Any, batch: int) -> Any:
        """KV caches: (L, B, S, hkv, hd) -> batch on data if divisible,
        else cache-seq on model (sequence-sharded decode)."""
        bshard = self.batch if _div(batch, self.data_size *
                                    (2 if self.multi_pod else 1)) else None

        def spec(path, leaf) -> P:
            name = path[-1]
            rank = leaf.ndim
            if name in ("k", "v"):            # (L, B, S, hkv, hd)
                seq_shard = self.model if _div(leaf.shape[2],
                                               self.model_size) else None
                return P(None, bshard, seq_shard, None, None)
            if name == "C":                   # (G, k, B, H, hd, hd)
                return P(None, None, bshard, None,
                         self.model if _div(leaf.shape[-2], self.model_size)
                         else None, None)
            if name == "ssm":                 # (G, k, B, H, N, P)
                return P(None, None, bshard, None, None, None)
            if name in ("conv", "n", "m", "c", "h"):
                # batch is the 3rd axis for stacked states, 2nd otherwise
                specs = [None] * rank
                for i, s in enumerate(leaf.shape):
                    if s == batch:
                        specs[i] = bshard
                        break
                return P(*specs)
            return P(*([None] * rank))

        return _map_with_path(spec, caches)


def _map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over a nested dict, the keys of each leaf's path
    as a tuple (``jax.tree_util.tree_map_with_path``'s dict keys)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def distribute(tree: Any, specs: Any, mesh) -> Any:
    """Each leaf of ``tree`` as a DTensor on ``mesh`` placed by its spec in
    ``specs`` (a tree of the same nesting): rank r keeps its own block."""
    from torch.distributed.tensor import distribute_tensor
    return tree_map(lambda t, s: distribute_tensor(
        t, mesh, placements(s, mesh, t.shape)), tree, specs)
