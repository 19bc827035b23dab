"""Per-device cost of one rank's program: FLOPs, bytes, collectives, peak.

The port's counterpart of ``repro.launch.hlo_walk`` and
``repro.launch.hlo_analysis``.  Those read the optimized XLA HLO text of a
compiled program; an eager PyTorch program has none, so ``Counter`` is a
``TorchDispatchMode`` that sees every aten op the program runs:

  flops       — ``torch.utils.flop_counter``'s formulas (2·M·N·K per
                product, ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` /
                convolutions / SDPA), on the LOCAL shards: entered above
                DTensor, a mode sees each DTensor op with global shapes
                (``FlopCounterMode`` there counts the global work), so the
                counter returns ``NotImplemented`` for DTensor ops and
                counts the local ops DTensor then runs on each rank's
                blocks.  The ops DTensor's sharding propagation runs on
                global-shape fake tensors to learn output shapes are not
                the program's and are skipped.
  hbm_bytes   — input plus output bytes of every aten op that is not a
                view, on the local shards.  This is the eager port's
                traffic, every op a round trip through device memory: an
                upper bound, not comparable with ``hlo_walk``'s count at
                XLA's fusion boundaries.
  coll_bytes  — per collective kind, result bytes times
                ``hlo_analysis``' traffic factor (all-reduce 2x, the rest
                1x), from the functional collectives DTensor and the
                layers issue (the ops ``CommDebugMode`` counts).
  peak bytes  — the most bytes of local storage alive at once: the
                tracked arguments plus every op output until its storage
                is freed (weak references on storages, so it works on
                fake tensors).

Hardware constants (NVIDIA H100 SXM5 data sheet; a model of a cluster of
H100s, not a measurement):
  989 TFLOP/s dense bf16 | 3.35 TB/s HBM3 | 50 GB/s per GPU between
  nodes: one 400 Gb/s InfiniBand NDR link (ConnectX-7) per GPU — the
  16-wide "model" axis spans two 8-GPU nodes, so its collectives cross
  that link.
"""

from __future__ import annotations

import dataclasses
import sys
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989e12        # dense bf16 tensor-core peak per GPU
HBM_BW = 3.35e12           # bytes/s per GPU (HBM3)
LINK_BW = 50e9             # bytes/s per GPU over InfiniBand NDR

# functional collective -> (hlo_analysis kind, traffic factor)
_COLLECTIVES = {
    "all_reduce": ("all-reduce", 2.0),
    "all_gather_into_tensor": ("all-gather", 1.0),
    "reduce_scatter_tensor": ("reduce-scatter", 1.0),
    "all_to_all_single": ("all-to-all", 1.0),
    "shard_dim_alltoall": ("all-to-all", 1.0),
    "broadcast": ("collective-permute", 1.0),
}
_COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# ops that move no data: a collective's wait, autograd's detach, and the
# allocations that do not write their output
_NO_TRAFFIC = {"wait_tensor", "detach", "empty", "empty_strided",
               "empty_like"}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _in_sharding_propagation() -> bool:
    """Whether DTensor's sharding propagation runs this op (to learn an
    output's global shape and stride on fake tensors)."""
    f = sys._getframe(2)
    for _ in range(32):
        if f is None:
            return False
        if f.f_code.co_name.startswith("_propagate_tensor_meta"):
            return True
        f = f.f_back
    return False


class Counter(TorchDispatchMode):
    """Counts one rank's program while it is entered (see the module
    docstring).  ``track(tree)`` adds tensors that exist before the
    program (arguments) to the live bytes."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.coll_by_op = {k: 0.0 for k in _COLL_KINDS}
        self.coll_counts: dict[str, int] = defaultdict(int)
        self.live = 0
        self.peak = 0
        self._storages: dict[int, weakref.ref] = {}

    # -- live bytes ------------------------------------------------------
    def _hold(self, t: torch.Tensor) -> None:
        from torch.distributed.tensor import DTensor
        if isinstance(t, DTensor):
            t = t._local_tensor
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages and self._storages[key]() is st:
            return
        n = st.nbytes()

        def release(_, n=n, key=key):
            self.live -= n
            self._storages.pop(key, None)
        self._storages[key] = weakref.ref(st, release)
        self.live += n
        self.peak = max(self.peak, self.live)

    def track(self, tree) -> int:
        """Hold every tensor of ``tree``; returns their local bytes."""
        before = self.live
        for t in _tensors(tree):
            self._hold(t)
        return self.live - before

    # -- dispatch --------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # let DTensor run its local ops
        out = func(*args, **kwargs)
        if _in_sharding_propagation():
            return out
        name = func._overloadpacket.__name__
        if name in _COLLECTIVES:
            kind, factor = _COLLECTIVES[name]
            b = sum(_nbytes(t) for t in _tensors(out))
            self.coll_by_op[kind] += b * factor
            self.coll_counts[kind] += 1
            self.hbm_bytes += b
        elif not func.is_view and name not in _NO_TRAFFIC:
            from torch.utils.flop_counter import flop_registry
            fn = flop_registry.get(func._overloadpacket)
            if fn is not None:
                self.flops += fn(*args, **kwargs, out_val=out)
            self.hbm_bytes += sum(_nbytes(t) for t in _tensors(args)) \
                + sum(_nbytes(t) for t in _tensors(kwargs)) \
                + sum(_nbytes(t) for t in _tensors(out))
        if not func.is_view:
            for t in _tensors(out):
                self._hold(t)
        return out

    @property
    def coll_bytes(self) -> float:
        return sum(self.coll_by_op.values())

    def roofline(self) -> "Roofline":
        return Roofline(flops=self.flops, hbm_bytes=self.hbm_bytes,
                        coll_bytes=self.coll_bytes,
                        coll_by_op=dict(self.coll_by_op),
                        peak_bytes_per_device=float(self.peak))


@dataclasses.dataclass
class Roofline:
    flops: float                 # program flops (per device)
    hbm_bytes: float             # bytes accessed (per device)
    coll_bytes: float            # collective traffic (per device)
    coll_by_op: dict[str, float]
    peak_bytes_per_device: float

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "coll_by_op": self.coll_by_op,
            "peak_bytes_per_device": self.peak_bytes_per_device,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "bottleneck": self.bottleneck,
        }


def model_flops(cfg, shape, n_tokens: int | None = None) -> float:
    """6*N*D for dense (N = params, D = tokens); 6*N_active*D for MoE.

    For decode steps, D = global_batch (one token per sequence)."""
    c = cfg
    d, L, ff, V = c.d_model, c.n_layers, c.d_ff, c.padded_vocab
    hd = c.resolved_head_dim
    attn = d * hd * (c.n_heads * 2 + c.n_kv_heads * 2)
    if c.n_experts:
        mlp_active = 3 * d * ff * c.experts_per_token
        n_active = L * (attn + mlp_active) + 2 * V * d
    elif c.family == "ssm":
        d_inner = c.ssm_expand * d
        n_active = L * (2 * d * 2 * d_inner // 2 + 3 * d_inner * d_inner
                        + d_inner * d) + 2 * V * d
    elif c.family == "hybrid":
        d_inner = c.ssm_expand * d
        n_mamba = L * (d * (2 * d_inner + 2 * c.ssm_state
                            + (c.ssm_heads or d_inner // 64))
                       + d_inner * d)
        n_shared = (L // max(c.shared_attn_every, 1)) * (attn + 3 * d * ff)
        n_active = n_mamba + n_shared + 2 * V * d
    else:
        n_active = L * (attn + 3 * d * ff) + 2 * V * d
        if c.is_encdec:
            n_active += c.encoder_layers * (attn + 3 * d * ff)
    if n_tokens is None:
        if shape.kind == "train":
            n_tokens = shape.seq_len * shape.global_batch
        elif shape.kind == "prefill":
            n_tokens = shape.seq_len * shape.global_batch
        else:
            n_tokens = shape.global_batch
    mult = 6 if shape.kind == "train" else 2
    return mult * n_active * n_tokens
