"""Scheduling-level layer specs + the GEMM-group iterator.

``LayerSpec`` is the normalized per-layer record every scheduler-facing
consumer reads (program compiler, FB request builder).  Networks are
*authored* through ``repro_torch.api.NetworkBuilder`` (shape inference +
build-time validation); the paper CNNs live in ``repro_torch.api.zoo``.
A copy of ``repro.core.workload``: the port imports nothing of the JAX
package.  The ``WORKLOADS`` registry is a deprecated compat shim over
the zoo, as in the JAX package.  Shapes follow the common CIFAR-10
variants of AlexNet / VGG-16 / ResNet-18 used by PUMAsim-style
evaluations; BatchNorm is folded into the preceding conv for inference.

Two layer vocabularies share this record:

* **CNN kinds** — ``conv | fc | relu | maxpool | avgpool | residual |
  softmax`` (the paper's workloads, §IV).
* **Sequence kinds** — ``linear | attention | layernorm | gelu |
  seqpool``: transformer encoder layers over ``(T, D)`` token buffers.
  ``linear`` is the sequence GEMM (last-dim contraction, tokens fold
  into the GEMM M axis), ``attention`` is one multi-head self-attention
  layer (``heads`` heads over ``features_in`` channels — the compiler
  expands it into qkv/scores/context/projection stages), ``layernorm``
  / ``gelu`` are FB post-ops, and ``seqpool`` mean-pools the token axis
  into a flat feature vector (the classifier-head transition).

Unlike the JAX package, a residual may read a group's *tap* (the value
before its closing layer norm, ``group_tap``), which pre-norm
transformer blocks need, and a layer norm may close a conv-headed
group (a ViT's patch embedding, its output rasterized to tokens).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Iterator

# kinds that head a GEMM group (own weights / mounts on the array)
GEMM_KINDS = ("conv", "fc", "linear", "attention")
# kinds that only appear in sequence (transformer) graphs
SEQ_KINDS = ("linear", "attention", "layernorm", "gelu", "seqpool")


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    name: str
    kind: str                  # one of GEMM_KINDS or a post-op kind
    in_ch: int = 0
    out_ch: int = 0
    ksize: int = 1
    stride: int = 1
    padding: int = 0
    in_hw: int = 0             # input spatial extent (square)
    out_hw: int = 0
    features_in: int = 0       # fc / linear / attention model dim
    features_out: int = 0
    residual_from: str = ""    # layer whose OUTPUT is the residual addend
    input_from: str = ""       # layer whose output this one consumes
                               # ("" = the immediately preceding layer)
    heads: int = 0             # attention only

    # -- workload numbers used by mapping/cycle models ----------------------
    @property
    def gemm_rows(self) -> int:            # im2col K
        if self.kind == "conv":
            return self.in_ch * self.ksize * self.ksize
        if self.kind in ("fc", "linear", "attention"):
            return self.features_in
        return 0

    @property
    def gemm_cols_logical(self) -> int:    # N (before bit-plane expansion)
        if self.kind == "conv":
            return self.out_ch
        if self.kind in ("fc", "linear", "attention"):
            return self.features_out
        return 0

    @property
    def n_vectors(self) -> int:            # GEMM passes (im2col columns)
        if self.kind == "conv":
            return self.out_hw * self.out_hw
        if self.kind in ("fc", "linear", "attention"):
            return 1
        return 0

    @property
    def n_elements(self) -> int:           # elementwise op count
        if self.kind in ("relu", "residual"):
            return (self.out_ch * self.out_hw * self.out_hw
                    or self.features_out)
        if self.kind in ("maxpool", "avgpool"):
            return self.out_ch * self.out_hw * self.out_hw  # windows
        if self.kind in ("softmax", "layernorm", "gelu", "seqpool"):
            return self.features_out
        return 0

    @property
    def out_bytes(self) -> int:
        if self.kind in ("conv", "relu", "maxpool", "avgpool", "residual"):
            return (self.out_ch * self.out_hw * self.out_hw
                    or self.features_out)
        return self.features_out


# -- the paper CNNs (compat shims over the repro_torch.api builder programs)
# The graphs themselves are authored in ``repro_torch.api.zoo`` through
# ``NetworkBuilder`` (imported lazily: api builds on top of core).

def alexnet_cifar() -> list[LayerSpec]:
    from repro_torch.api.zoo import alexnet_graph
    return list(alexnet_graph().layers)


def vgg16_cifar() -> list[LayerSpec]:
    from repro_torch.api.zoo import vgg16_graph
    return list(vgg16_graph().layers)


def resnet18_cifar() -> list[LayerSpec]:
    from repro_torch.api.zoo import resnet18_graph
    return list(resnet18_graph().layers)


class _WorkloadShim(dict):
    """Deprecated registry: warns and forwards to ``repro_torch.api.zoo``."""

    def __getitem__(self, net):
        warnings.warn(
            "core.workload.WORKLOADS is deprecated; author networks with "
            "repro_torch.api.NetworkBuilder and use the repro_torch.api.zoo "
            "registry (api.zoo.GRAPHS / api.compile(name)) instead",
            DeprecationWarning, stacklevel=2)
        return super().__getitem__(net)


WORKLOADS = _WorkloadShim({
    "alexnet": alexnet_cifar,
    "vgg16": vgg16_cifar,
    "resnet18": resnet18_cifar,
})


# canonical FB chain order inside one fused group (gemm implicit first):
# residual -> relu|gelu -> pool -> layernorm -> seqpool -> softmax.
# The CNN subset (paper Fig 4a merges res under conv, §II-C2 merges ReLU
# into max pool, softmax consumes the fc head) keeps its historical
# order; the sequence kinds slot in where post-norm transformer blocks
# produce them (residual -> layernorm, linear -> gelu, final block ->
# seqpool).  Activations share a rank (they never chain), and spatial
# pools can never precede a layernorm because pools are spatial-only
# while layernorm is sequence-only.  Shared by the program compiler and
# the api builder's build-time check.
POST_RANK = {"residual": 0, "relu": 1, "gelu": 1, "maxpool": 2,
             "avgpool": 2, "layernorm": 3, "seqpool": 4, "softmax": 5}


def group_tap(group: list[LayerSpec]) -> str:
    """The layer of ``group`` whose buffer a later residual may read
    besides the group's final one, or ``""``.

    Pre-norm blocks (``x = x + f(LN(x))``) read the residual stream
    *before* the layer norm that ends its group: a **tap**, the layer
    before a closing ``layernorm`` (the head, a residual or an
    activation: the chain orders them before it, and the builder refuses
    a layer norm after a pool), which the epilogue stores beside the
    normalized rows in the same pass."""
    if len(group) > 1 and group[-1].kind == "layernorm":
        return group[-2].name
    return ""


def input_spec(layers: list[LayerSpec]) -> tuple[int, int, int, int]:
    """``(in_hw, in_ch, in_features, in_seq)`` read off the first layer.

    The single derivation of a network's input signature — consumed by
    ``NetworkGraph.from_layers`` and ``compile_network`` so serving
    warmup and graph input shapes can never disagree.  ``in_seq`` is the
    model dim of a sequence-input net (``(B, T, in_seq)`` batches, T
    picked at run time); conv-first nets set ``in_hw``/``in_ch`` and
    fc-first nets set ``in_features`` exactly as before.
    """
    head = layers[0]
    if head.kind == "conv":
        return head.in_hw, head.in_ch, 0, 0
    if head.kind in ("linear", "attention"):
        return 0, 0, 0, head.features_in
    return 0, 0, head.features_in, 0


def layer_groups(layers: list[LayerSpec]) -> Iterator[list[LayerSpec]]:
    """Group each GEMM layer with its trailing elementwise/pool consumers.

    One group becomes one FB chain inside one (set of) array(s) — the unit
    HURRY schedules (conv + res + relu + pool fused; §III-A).  A non-GEMM
    layer before any GEMM head has no group to attach to — that is a
    malformed network, rejected here (and earlier, with the same message,
    by ``repro_torch.api.NetworkBuilder`` at graph-build time).
    """
    group: list[LayerSpec] = []
    for l in layers:
        if l.kind in GEMM_KINDS:
            if group:
                yield group
            group = [l]
        else:
            if not group:
                raise ValueError(
                    f"layer {l.name!r} ({l.kind}) precedes any GEMM layer; "
                    "every post-op must follow a GEMM group head (conv/fc, "
                    "or linear/attention for sequence chains)")
            group.append(l)
    if group:
        yield group
