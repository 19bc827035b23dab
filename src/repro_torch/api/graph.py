"""Network IR: ``NetworkBuilder`` -> ``NetworkGraph`` with shape inference.

The builder is the front-door authoring surface — users describe a
network op by op (``nb.conv(...)``, ``nb.relu()``, ``nb.maxpool()``,
``nb.residual(from_=...)``, ``nb.fc(...)``, ``nb.softmax()``) and every
call infers the output shape from the running input shape, validating as
it goes: GEMM-headed groups (a non-GEMM layer before any GEMM head is an
error naming the layer), known wiring sources, shape-matched residuals,
window == stride pooling (the only pooling the FB column tiling maps),
and the canonical FB chain order ``residual -> relu -> pool -> softmax``
(paper Fig 4a / §II-C2).  Errors surface at *build* time with the
offending layer's name, not deep inside the compiler.

**Sequence mode** (DESIGN.md §9): the same builder authors transformer
graphs over ``(T, D)`` token shapes — ``nb.linear(features)``,
``nb.layernorm()``, ``nb.gelu()``, ``nb.attention(heads)``,
``nb.seqpool()``.  A spatial buffer entering a sequence op is
rasterized into ``T = hw^2`` tokens (the ViT patchify transition); a
network may also start directly in token space via
``NetworkBuilder(input_seq_dim=D)``, in which case the sequence length
is a run-time property of the batch (``T`` is tracked as 0 during
inference of shapes).  The sequence FB chain order is ``residual ->
gelu -> layernorm -> seqpool`` (post-norm transformer blocks).

**Pre-norm blocks** (``x = x + f(LN(x))``, every published ViT): a
residual may also read a *tap* of an earlier group, the value its
chain holds before the layer norm that ends it
(``core.workload.group_tap``), which the compiled stage stores as a
second output; and a layer norm may close a conv-headed group, whose
output it rasterizes into tokens (a ViT's normalized patch embedding).
``zoo.vit_s16_graph`` is built that way.

The resulting ``NetworkGraph`` is the one source of truth for layer
shapes: the scheduler consumes its ``LayerSpec`` list, ``init_params``
derives the parameter dict from it, and ``forward`` is a generic
functional interpreter (same primitives as ``models/cnn.py``, GEMMs
routed through any ``mm``: float32 or the crossbar functional model)
used as the numeric reference for compiled programs.  Attention routes
all four of its GEMMs (fused qkv projection, per-head Q·Kᵀ, per-head
P·V, output projection) through the same ``mm``, so the oracle
evaluates the crossbar-quantized attention the compiled program
executes.

The port of ``repro.api.graph``: the builder and its validation are the
JAX package's, line for line, except that the port's builder goes beyond
it with the two pre-norm wirings above, which the JAX builder rejects
(``residual source ... is not a materialized group output``, ``... is a
sequence FB but its group head is a conv``).  ``init_params`` draws He
init from a
``torch.Generator``, so its numbers differ from ``jax.random``'s; tests
carry the JAX package's parameters over with ``convert.params_from_jax``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.workload import (LayerSpec, POST_RANK, group_tap,
                                       input_spec, layer_groups)
from repro_torch.kernels.fb_epilogue import (avg_windows, gelu,
                                             layer_norm_rows, softmax_rows)
from repro_torch.models.cnn import MatmulFn, conv2d, fp_matmul, maxpool
from repro_torch.program.sequence import (attn_scale, merge_heads,
                                          split_qkv_heads, tokens)

# shapes are ("spatial", hw, ch) until an fc flattens to ("flat", features)
# or a sequence op rasterizes to ("seq", tokens, dim); T == 0 marks a
# run-time sequence length (sequence-input nets)
_SPATIAL, _FLAT, _SEQ = "spatial", "flat", "seq"
_AUTO_PREFIX = {"conv": "conv", "fc": "fc", "relu": "relu",
                "maxpool": "pool", "avgpool": "avgpool",
                "residual": "res", "softmax": "softmax",
                "linear": "lin", "layernorm": "ln", "gelu": "gelu",
                "attention": "attn", "seqpool": "seqpool"}


def _as_tokens(shape: tuple) -> tuple:
    """Shape-level analogue of ``sequence.tokens``: spatial -> seq."""
    if shape[0] == _SPATIAL:
        return (_SEQ, shape[1] * shape[1], shape[2])
    return shape


@dataclasses.dataclass(frozen=True)
class NetworkGraph:
    """A validated, shape-inferred network: the builder's output."""

    name: str
    in_hw: int
    in_ch: int
    layers: tuple[LayerSpec, ...]
    in_features: int = 0          # set instead of hw/ch for fc-first nets
    in_seq: int = 0               # model dim for sequence-input nets

    def input_shape(self, batch: int = 1, seq_len: int = 16
                    ) -> tuple[int, ...]:
        if self.in_seq:
            return (batch, seq_len, self.in_seq)
        if self.in_features:
            return (batch, self.in_features)
        return (batch, self.in_hw, self.in_hw, self.in_ch)

    def init_params(self, generator: torch.Generator | None = None, *,
                    device=None) -> dict:
        """He-init parameter dict whose shapes come from the graph.

        ``{layer: {"w": ..., "b": ...}}`` (attention: ``wqkv``/``bqkv``/
        ``wo``/``bo``; layer norm: ``g``/``b``), float32, in the JAX
        package's layouts (conv weights ``(k, k, in_ch, out_ch)``).
        Drawn on the CPU from ``generator`` (seed 0 when omitted), so a
        seed gives the same weights on every device, then moved to
        ``device``.
        """
        if generator is None:
            generator = torch.Generator().manual_seed(0)

        def he(shape, fan_in):
            return (torch.randn(shape, generator=generator)
                    * math.sqrt(2.0 / fan_in))

        params: dict = {}
        for l in self.layers:
            if l.kind == "conv":
                fan_in = l.ksize * l.ksize * l.in_ch
                params[l.name] = {
                    "w": he((l.ksize, l.ksize, l.in_ch, l.out_ch), fan_in),
                    "b": torch.zeros(l.out_ch)}
            elif l.kind in ("fc", "linear"):
                params[l.name] = {
                    "w": he((l.features_in, l.features_out), l.features_in),
                    "b": torch.zeros(l.features_out)}
            elif l.kind == "attention":
                d = l.features_in
                params[l.name] = {"wqkv": he((d, 3 * d), d),
                                  "bqkv": torch.zeros(3 * d),
                                  "wo": he((d, d), d),
                                  "bo": torch.zeros(d)}
            elif l.kind == "layernorm":
                params[l.name] = {"g": torch.ones(l.features_out),
                                  "b": torch.zeros(l.features_out)}
        return {k: {n: t.to(device) for n, t in p.items()}
                for k, p in params.items()}

    def forward(self, params: dict, x: torch.Tensor, *,
                mm: MatmulFn = fp_matmul, logits: bool = False
                ) -> torch.Tensor:
        """Generic functional forward over the graph (the numeric oracle).

        Interprets the layer list with the same primitives as the
        handwritten CNN forwards, routing every GEMM through ``mm``
        (``models.cnn.make_crossbar_matmul(cfg)`` for the crossbar
        model), the two *dynamic-operand* GEMMs inside attention
        included: those pass ``mm`` the (batch x head) slice axis, so the
        crossbar quantizes each slice with its own scale, as ``jax.vmap``
        over ``mm`` does in the JAX package, and runs them all in one
        ``crossbar_gemm`` call.  ``params`` and ``x`` share a device.
        ``logits=True`` returns the last GEMM output (pre-softmax).

        With the crossbar ``mm`` on the CPU this equals
        ``CompiledModel.run(x, logits=True)`` on the same parameters bit
        for bit (held for AlexNet, VGG-16, ResNet-18, vit_tiny and a
        net with every CNN FB): both quantize, requantize and add the
        bias in the same roundings, and compute the FB bodies with the
        same plain PyTorch functions.  The JAX package gets that only
        with both sides jitted.  On a GPU ``run``'s epilogues are the
        ``fb_epilogue`` kernel, which agrees with those functions to the
        tolerances its tests state.
        """
        bufs: dict[str, torch.Tensor] = {"input": x}
        cur = "input"
        last_gemm = cur
        for l in self.layers:
            if l.kind == "conv":
                src = bufs[l.input_from or cur]
                p = params[l.name]
                y = conv2d(src, p["w"], p["b"], l.stride, l.padding, mm)
                last_gemm = l.name
            elif l.kind == "fc":
                src = bufs[l.input_from or cur]
                if src.dim() == 4:
                    src = src.reshape(src.shape[0], -1)
                p = params[l.name]
                y = mm(src, p["w"], p["b"])
                last_gemm = l.name
            elif l.kind == "linear":
                src = tokens(bufs[l.input_from or cur])
                b, t, d = src.shape
                p = params[l.name]
                y = mm(src.reshape(b * t, d), p["w"], p["b"]).reshape(
                    b, t, -1)
                last_gemm = l.name
            elif l.kind == "attention":
                src = tokens(bufs[l.input_from or cur])
                b, t, d = src.shape
                p = params[l.name]
                qkv = mm(src.reshape(b * t, d), p["wqkv"], p["bqkv"])
                q, kk, v = split_qkv_heads(qkv.reshape(b, t, 3 * d),
                                           l.heads)
                scores = mm(q, kk.transpose(1, 2))
                probs = softmax_rows(scores * attn_scale(d // l.heads))
                ctx = merge_heads(mm(probs, v), l.heads)
                y = mm(ctx.reshape(b * t, d), p["wo"], p["bo"]).reshape(
                    b, t, d)
                last_gemm = l.name
            elif l.kind == "relu":
                y = torch.relu(bufs[cur])
            elif l.kind == "gelu":
                y = gelu(bufs[cur])
            elif l.kind == "layernorm":
                p = params[l.name]
                y = layer_norm_rows(tokens(bufs[cur]), p["g"], p["b"])
            elif l.kind == "maxpool":
                y = maxpool(bufs[cur], l.ksize, l.stride)
            elif l.kind == "avgpool":
                v = bufs[cur]
                b, h, w_, c = v.shape
                y = avg_windows(v.reshape(b, h // l.ksize, l.ksize,
                                          w_ // l.ksize, l.ksize, c))
            elif l.kind == "seqpool":
                y = tokens(bufs[cur]).mean(dim=1)
            elif l.kind == "residual":
                a = bufs[cur]
                r = bufs[l.residual_from]
                y = a + (tokens(r) if a.dim() == 3 else r)
            elif l.kind == "softmax":
                y = softmax_rows(bufs[cur])
            else:
                raise ValueError(f"{l.name}: unknown layer kind {l.kind!r}")
            bufs[l.name] = y
            cur = l.name
        return bufs[last_gemm if logits else cur]

    @classmethod
    def from_layers(cls, layers, name: str = "custom") -> "NetworkGraph":
        """Wrap a raw ``LayerSpec`` list (compat path for old call sites).

        Validates GEMM-headed grouping; the input spec is read off the
        first layer.
        """
        layers = tuple(layers)
        if not layers:
            raise ValueError("empty network")
        for _ in layer_groups(list(layers)):   # raises on headless groups
            pass
        ihw, ich, ifeat, iseq = input_spec(list(layers))
        return cls(name=name, in_hw=ihw, in_ch=ich, in_features=ifeat,
                   in_seq=iseq, layers=layers)


class NetworkBuilder:
    """Incremental network authoring with per-op shape inference.

    Every method appends one layer, infers its output shape, validates,
    and returns the layer's name (usable as ``input_from=`` /
    ``from_=`` wiring for branches).  ``build()`` returns the immutable
    ``NetworkGraph``.  Pass ``input_hw``/``input_ch`` for image-input
    nets or ``input_seq_dim`` for token-input nets ((B, T, D) batches
    with T chosen at run time).
    """

    def __init__(self, name: str = "custom", *, input_hw: int = 0,
                 input_ch: int = 0, input_seq_dim: int = 0):
        has_img = bool(input_hw or input_ch)
        if bool(input_seq_dim) == has_img:
            raise ValueError(
                f"{name}: pass either input_hw+input_ch (image input) or "
                "input_seq_dim (token input)")
        if has_img and not (input_hw and input_ch):
            raise ValueError(
                f"{name}: image input needs BOTH input_hw and input_ch "
                f"(got hw={input_hw}, ch={input_ch})")
        self.name = name
        self._in = (input_hw, input_ch, input_seq_dim)
        self._layers: list[LayerSpec] = []
        self._shapes: dict[str, tuple] = {
            "input": ((_SEQ, 0, input_seq_dim) if input_seq_dim
                      else (_SPATIAL, input_hw, input_ch))}
        self._cur = "input"
        self._finals = {"input"}      # materialized group-final buffers
        self._taps: set[str] = set()  # closed groups' taps (group_tap)
        self._group: list[LayerSpec] = []     # the open group's layers
        self._counts: dict[str, int] = {}
        self._has_gemm = False
        self._head_kind = ""          # kind of the current group's head

    # -- internals ---------------------------------------------------------

    def _name(self, kind: str, name: str | None) -> str:
        if name is None:
            n = self._counts.get(kind, 0) + 1
            self._counts[kind] = n
            name = f"{_AUTO_PREFIX[kind]}{n}"
        if name in self._shapes:
            raise ValueError(f"duplicate layer name {name!r}")
        return name

    def _src_shape(self, name: str, src: str, want: str) -> tuple:
        if src not in self._shapes:
            raise ValueError(f"{name}: unknown input layer {src!r}")
        shape = self._shapes[src]
        if want == _SEQ:
            shape = _as_tokens(shape)      # spatial rasterizes into tokens
        if shape[0] != want:
            raise ValueError(
                f"{name}: needs a {want} input, but {src!r} produces "
                f"{shape[0]} output {shape[1:]}")
        return shape

    def _require_gemm(self, name: str, kind: str) -> None:
        if not self._has_gemm:
            raise ValueError(
                f"layer {name!r} ({kind}) precedes any GEMM layer; every "
                "post-op must follow a GEMM group head — conv/fc, or "
                "linear/attention for sequence chains (HURRY schedules "
                "GEMM-headed FB groups)")

    def _require_seq_head(self, name: str, kind: str) -> None:
        """Sequence FBs only fuse onto linear/attention-headed groups.

        A conv/fc group cannot host them (the compiler's CNN lowering
        has no such FB requests), so reject at build time with the
        layer named rather than deep inside ``compile_network``.
        """
        self._require_gemm(name, kind)
        if self._head_kind not in ("linear", "attention"):
            raise ValueError(
                f"layer {name!r} ({kind}) is a sequence FB but its group "
                f"head is a {self._head_kind}; gelu/layernorm/seqpool "
                "fuse onto linear or attention group heads only")

    def _open_group(self, name: str, input_from: str, kind: str) -> str:
        """A new GEMM closes the previous group: its output materializes.

        Returns the resolved source name; validates explicit wiring only
        targets materialized group-final buffers.
        """
        self._finals = self._finals | {self._cur}
        if self._group and (tap := group_tap(self._group)):
            self._taps.add(tap)
        self._group = []
        src = input_from or self._cur
        if input_from and input_from not in self._finals:
            raise ValueError(
                f"{name}: input_from={input_from!r} is not a materialized "
                "group output (only group-final buffers are wired)")
        self._has_gemm = True
        self._head_kind = kind
        return src

    def _add(self, spec: LayerSpec, shape: tuple) -> str:
        self._layers.append(spec)
        self._group.append(spec)
        self._shapes[spec.name] = shape
        self._cur = spec.name
        return spec.name

    # -- ops ---------------------------------------------------------------

    def conv(self, out_ch: int, k: int = 3, stride: int = 1,
             padding: int = 1, *, name: str | None = None,
             input_from: str = "") -> str:
        name = self._name("conv", name)
        src = self._open_group(name, input_from, "conv")
        _, hw, ch = self._src_shape(name, src, _SPATIAL)
        out_hw = (hw + 2 * padding - k) // stride + 1
        if out_hw <= 0:
            raise ValueError(f"{name}: {k}x{k}/s{stride}/p{padding} conv "
                             f"over {hw}x{hw} input has no output")
        return self._add(
            LayerSpec(name, "conv", in_ch=ch, out_ch=out_ch, ksize=k,
                      stride=stride, padding=padding, in_hw=hw,
                      out_hw=out_hw, input_from=input_from),
            (_SPATIAL, out_hw, out_ch))

    def fc(self, features_out: int, *, name: str | None = None,
           input_from: str = "") -> str:
        name = self._name("fc", name)
        src = self._open_group(name, input_from, "fc")
        shape = self._shapes.get(src)
        if shape is None:
            raise ValueError(f"{name}: unknown input layer {src!r}")
        fin = shape[1] * shape[1] * shape[2] if shape[0] == _SPATIAL \
            else shape[1]
        return self._add(
            LayerSpec(name, "fc", features_in=fin,
                      features_out=features_out, input_from=input_from),
            (_FLAT, features_out))

    def linear(self, features_out: int, *, name: str | None = None,
               input_from: str = "") -> str:
        """Sequence GEMM: (T, D) -> (T, features_out), tokens in M."""
        name = self._name("linear", name)
        src = self._open_group(name, input_from, "linear")
        _, t, d = self._src_shape(name, src, _SEQ)
        return self._add(
            LayerSpec(name, "linear", features_in=d,
                      features_out=features_out, input_from=input_from),
            (_SEQ, t, features_out))

    def attention(self, heads: int, *, name: str | None = None,
                  input_from: str = "") -> str:
        """Multi-head self-attention over the token buffer, (T, D)->(T, D).

        One builder op; the program compiler expands it into the fused
        qkv projection, the two dynamic-operand GEMM stages (Q·Kᵀ with a
        fused softmax FB, P·V), and the output projection (DESIGN.md §9).
        """
        name = self._name("attention", name)
        src = self._open_group(name, input_from, "attention")
        _, t, d = self._src_shape(name, src, _SEQ)
        if heads < 1 or d % heads:
            raise ValueError(
                f"{name}: {heads} heads do not divide model dim {d}")
        return self._add(
            LayerSpec(name, "attention", features_in=d, features_out=d,
                      heads=heads, input_from=input_from),
            (_SEQ, t, d))

    def relu(self, *, name: str | None = None) -> str:
        name = self._name("relu", name)
        self._require_gemm(name, "relu")
        shape = self._shapes[self._cur]
        if shape[0] == _SPATIAL:
            spec = LayerSpec(name, "relu", out_ch=shape[2], out_hw=shape[1])
        else:
            spec = LayerSpec(name, "relu", features_out=shape[-1])
        return self._add(spec, shape)

    def gelu(self, *, name: str | None = None) -> str:
        """GELU FB (sequence chains; the LUT analogue of the relu FB)."""
        name = self._name("gelu", name)
        self._require_seq_head(name, "gelu")
        shape = self._src_shape(name, self._cur, _SEQ)
        return self._add(
            LayerSpec(name, "gelu", features_out=shape[2]), shape)

    def layernorm(self, *, name: str | None = None) -> str:
        """Layer norm FB over the feature axis of a token buffer; after a
        conv head, with no pool before it, the conv's pixels are the
        tokens."""
        name = self._name("layernorm", name)
        if not (self._head_kind == "conv" and not any(
                l.kind in ("maxpool", "avgpool") for l in self._group)):
            self._require_seq_head(name, "layernorm")
        shape = self._src_shape(name, self._cur, _SEQ)
        return self._add(
            LayerSpec(name, "layernorm", features_out=shape[2]), shape)

    def seqpool(self, *, name: str | None = None) -> str:
        """Mean-pool the token axis: (T, D) -> flat (D,) (ViT-style head)."""
        name = self._name("seqpool", name)
        self._require_seq_head(name, "seqpool")
        shape = self._src_shape(name, self._cur, _SEQ)
        return self._add(
            LayerSpec(name, "seqpool", features_out=shape[2]),
            (_FLAT, shape[2]))

    def _pool(self, kind: str, k: int, stride: int,
              name: str | None) -> str:
        name = self._name(kind, name)
        self._require_gemm(name, kind)
        if k != stride:
            raise ValueError(
                f"{name}: only window == stride pooling maps onto the FB "
                f"column tiling (got window {k}, stride {stride})")
        _, hw, ch = self._src_shape(name, self._cur, _SPATIAL)
        if hw % k:
            raise ValueError(f"{name}: {k}x{k} window does not tile the "
                             f"{hw}x{hw} input")
        return self._add(
            LayerSpec(name, kind, out_ch=ch, ksize=k, stride=stride,
                      in_hw=hw, out_hw=hw // stride),
            (_SPATIAL, hw // stride, ch))

    def maxpool(self, k: int = 2, stride: int = 2, *,
                name: str | None = None) -> str:
        return self._pool("maxpool", k, stride, name)

    def avgpool(self, k: int = 2, stride: int = 2, *,
                name: str | None = None) -> str:
        return self._pool("avgpool", k, stride, name)

    def residual(self, from_: str, *, name: str | None = None) -> str:
        name = self._name("residual", name)
        self._require_gemm(name, "residual")
        if from_ not in self._finals and from_ not in self._taps:
            raise ValueError(
                f"{name}: residual source {from_!r} is not a materialized "
                "group output (it must be a previous group's final buffer, "
                "or its tap: the value before the layer norm that ends "
                "it)")
        shape = self._shapes[self._cur]
        src_shape = self._shapes[from_]
        if shape[0] == _SEQ:           # spatial addends rasterize to tokens
            src_shape = _as_tokens(src_shape)
        if src_shape != shape:
            raise ValueError(
                f"{name}: residual source {from_!r} shape "
                f"{src_shape[1:]} != current {shape[1:]}")
        if shape[0] == _SEQ:
            spec = LayerSpec(name, "residual", features_out=shape[2],
                             residual_from=from_)
        else:
            _, hw, ch = self._src_shape(name, self._cur, _SPATIAL)
            spec = LayerSpec(name, "residual", out_ch=ch, out_hw=hw,
                             residual_from=from_)
        return self._add(spec, shape)

    def softmax(self, *, name: str | None = None) -> str:
        name = self._name("softmax", name)
        self._require_gemm(name, "softmax")
        shape = self._src_shape(name, self._cur, _FLAT)
        return self._add(
            LayerSpec(name, "softmax", features_out=shape[1]), shape)

    # -- finalize ----------------------------------------------------------

    def build(self) -> NetworkGraph:
        if not self._layers:
            raise ValueError(f"{self.name}: empty network")
        # grouping + canonical chain order validation (same POST_RANK
        # table as the compiler, so errors surface at build time with
        # layer names and the two checks can never diverge)
        for group in layer_groups(list(self._layers)):
            rank = -1
            for l in group[1:]:
                if POST_RANK[l.kind] <= rank:
                    raise ValueError(
                        f"{l.name}: {l.kind} out of canonical FB chain "
                        "order (residual -> relu|gelu -> pool -> "
                        "layernorm -> seqpool -> softmax) in "
                        f"group {group[0].name!r}")
                rank = POST_RANK[l.kind]
        hw, ch, seq = self._in
        return NetworkGraph(name=self.name, in_hw=hw, in_ch=ch,
                            in_seq=seq, layers=tuple(self._layers))
