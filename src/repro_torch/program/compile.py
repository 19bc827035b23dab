"""Compiler: lower a scheduled network into an executable ``CrossbarProgram``.

The lowering pipeline per GEMM layer group (paper §III):

  1. ``build_group_requests`` turns the group (conv|fc + trailing
     res/relu/pool/softmax) into FB requests + consumer edges (HMS).
  2. ``plan_array`` runs Algorithm 2 (FB size balancing) and Algorithm 1
     + sequence-pair decoding, yielding the placed ``ArrayPlan``.
  3. The GEMM request's per-array slice (bx, by) fixes the **tile
     shape**: ``tile_rows`` rows of the im2col matrix per mount (also
     the ADC row-chunk — each mount is one physical array read) and
     ``tile_cols`` logical output columns (the FB's column capacity
     divided by the weight bit planes).
  4. The full weight matrix is partitioned into **mount rounds** —
     ``ceil(K / tile_rows) x ceil(N / tile_cols)`` rectangular weight
     slices, the sequence of array (re)configurations that covers the
     layer.  Row-adjacent mounts are partial-sum chained (SnA across
     stacked arrays); column-adjacent mounts concatenate outputs.
  5. Each layer becomes a ``ProgramOp`` with explicit buffer wiring
     (``src``/``dst``/``res_src`` name the producing layer's buffer),
     so the executor is a pure dataflow interpreter.

Because consumer FBs always reserve rows below the GEMM FB, every tile
has ``tile_rows < array_rows``; with the paper's 9-bit ADC this makes
every program GEMM clip-free (DESIGN.md §4) — the scheduled program is
*exactly* a quantized int GEMM pipeline.

**Sequence groups** (DESIGN.md §9) lower through a parallel path:
``linear`` heads become ordinary weight-mounted GEMM stages whose M axis
folds the token dimension, and an ``attention`` head expands into FOUR
stages — the fused qkv projection (compile-time weights), the two
**dynamic-operand GEMM** stages (``kind="dyn_gemm"``: Q·Kᵀ with a fused
softmax FB and the `1/sqrt(hd)` logit scale, then P·V), and the output
projection.  Dynamic stages mount *runtime activations* instead of
compile-time weights, so their mount geometry cannot be enumerated
here: they carry a ``tile_rows`` row budget (the array height minus the
consumer-FB reservation) and the executor sizes the K grid to the
actual contraction length per batch — the paper's block-activation
scheme applied to dynamically sized mounts.  Their FB row reservations
come from the fixed ``_SEQ_FB_ROWS`` table (sequence FBs are not in the
Algorithm 1/2 vocabulary, and a dynamic stage's element count is
unknown at compile time), so sequence groups skip ``plan_array``.

The FB op vocabulary is ``gemm | dyn_gemm | relu | gelu | maxpool |
avgpool | layernorm | seqpool | residual | softmax``; post-ops must
follow the canonical FB chain order ``residual -> relu|gelu -> pool ->
layernorm -> seqpool -> softmax`` (``core.workload.POST_RANK``).

The port of ``repro.program.compile``, line for line: it is pure Python,
and its ``ProgramOp`` lists equal the JAX package's field for field.
Beyond it, for pre-norm transformer blocks: a residual may read an
earlier group's **tap** (``core.workload.group_tap``, the value its chain
holds before the layer norm that ends it), which makes that buffer a
second materialized output of the stage (``CrossbarProgram.taps``; no
``ProgramOp`` field, so a program without taps is the JAX package's);
and a layer norm may close a conv group, lowered with the CNN groups
(its rows reserved below the GEMM slice, ``simulator.LN_ROWS``).
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.crossbar import CrossbarConfig
from repro_torch.core.scheduling import ArrayPlan, plan_array
from repro_torch.core.simulator import (LN_ROWS, ChipConfig,
                                        build_group_requests)
from repro_torch.core.workload import (POST_RANK, SEQ_KINDS, group_tap,
                                       input_spec, layer_groups)

from .sequence import attn_scale

# workload layer kind -> FB request kind in the ArrayPlan (ReLU merges
# into the max FB when a pool follows, paper §II-C2)
_FB_KIND = {"maxpool": ("max",), "relu": ("relu", "max"),
            "residual": ("res",), "softmax": ("softmax",)}

# rows each sequence FB reserves below the GEMM slice (the sequence
# analogue of ``build_group_requests``' consumer budget): residual = 8
# merged input bit rows (Fig 4a); gelu/seqpool = a 16-bit operand pair
# plus LUT staging; layernorm = two 16-bit statistic accumulators plus
# the scale/shift constants; softmax = the fp16 max/exp tournament
# budget.  A dynamic P·V stage with no consumer still reserves
# ``_SEQ_OR_ROWS`` output-register staging rows.
_SEQ_FB_ROWS = {"residual": 8, "relu": 18, "gelu": 18, "layernorm": LN_ROWS,
                "seqpool": 18, "softmax": 26}
_SEQ_OR_ROWS = 8


@dataclasses.dataclass(frozen=True)
class MountRound:
    """One array (re)configuration: a rectangular weight slice.

    ``[k0:k1]`` rows of the im2col weight matrix and logical output
    columns ``[n0:n1]``.  Mounts sharing columns are partial-sum chained
    over K (SnA); mounts sharing rows concatenate over N.
    """

    round_id: int
    k0: int
    k1: int
    n0: int
    n1: int


@dataclasses.dataclass(frozen=True)
class ProgramOp:
    """One FB op of the static program (see module docstring)."""

    kind: str                  # gemm|dyn_gemm|relu|gelu|maxpool|avgpool|
                               # layernorm|seqpool|residual|softmax
    name: str                  # producing workload layer
    src: str                   # input buffer (a ProgramOp name or "input")
    dst: str                   # output buffer (== name)
    # gemm
    param: str = ""            # model params key ("" = no parameters)
    w_key: str = "w"           # weight/bias keys inside params[param]
    b_key: str = "b"           # (attention packs wqkv/bqkv + wo/bo)
    is_conv: bool = False
    seq: bool = False          # operates on (B, T, D) token buffers
    ksize: int = 1
    stride: int = 1
    padding: int = 0
    out_hw: int = 0            # spatial extent of the gemm output (conv)
    out_ch: int = 0            # logical N (0 for dynamic-N stages)
    tile_rows: int = 0         # per-mount K slice == ADC row chunk
    tile_cols: int = 0         # per-mount logical N slice
    mount_rounds: tuple[MountRound, ...] = ()
    # dynamic-operand gemm (attention)
    dyn: str = ""              # "qk" (scores) | "pv" (context)
    dyn_src: str = ""          # buffer mounted as the dynamic operand
    heads: int = 0
    post_scale: float = 0.0    # static factor folded into the epilogue
    # pool
    window: int = 0            # pool window edge (== stride; VALID)
    in_hw: int = 0             # spatial extent entering the pool
    # residual
    res_src: str = ""          # buffer holding the residual addend
    # decoded FB placement (from the group's ArrayPlan; -1 = no FB,
    # e.g. avgpool which HURRY computes in the SnA/LUT datapath, and
    # every sequence FB, which skips plan_array)
    fb_row0: int = -1
    fb_col0: int = -1
    fb_rows: int = 0
    fb_cols: int = 0


# stage heads: ops that dispatch the crossbar (own a packed/dynamic mount)
GEMM_OPS = ("gemm", "dyn_gemm")


@dataclasses.dataclass(frozen=True)
class CrossbarProgram:
    """A compiled network: static op list + per-group array plans."""

    net: str
    cfg: CrossbarConfig
    ops: tuple[ProgramOp, ...]
    plans: tuple[ArrayPlan, ...]
    input: str
    output: str                # final buffer (softmax output when present)
    logits: str                # last GEMM-stage buffer (pre-softmax)
    # input spec (read off the first layer at compile time); serving
    # warmup derives its dummy batch from this, never from a hardcoded
    # CIFAR shape
    in_hw: int = 32
    in_ch: int = 3
    in_features: int = 0       # set instead of hw/ch for fc-first nets
    in_seq: int = 0            # model dim for sequence-input nets

    def input_shape(self, batch: int = 1, seq_len: int = 16
                    ) -> tuple[int, ...]:
        """The (batched) input array shape this program was compiled for.

        Sequence-input programs take their token count from ``seq_len``
        (a run-time property of the batch, not of the program).
        """
        if self.in_seq:
            return (batch, seq_len, self.in_seq)
        if self.in_features:
            return (batch, self.in_features)
        return (batch, self.in_hw, self.in_hw, self.in_ch)

    @property
    def n_mount_rounds(self) -> int:
        return sum(len(op.mount_rounds) for op in self.ops
                   if op.kind == "gemm")

    @property
    def has_dynamic_stages(self) -> bool:
        return any(op.kind == "dyn_gemm" for op in self.ops)

    def taps(self) -> dict[str, str]:
        """Stage (its GEMM op's name) -> its tap: the buffer of its FB
        chain, short of the last, that a later residual reads, which
        the stage stores as a second output.  Derived from the ops, so
        a saved program keeps it."""
        read = {op.res_src for op in self.ops if op.kind == "residual"}
        out = {}
        for gemm, posts in self.stages():
            for op in [gemm, *posts][:-1]:
                if op.dst in read:
                    out[gemm.name] = op.dst
        return out

    def stages(self) -> list[tuple[ProgramOp, list[ProgramOp]]]:
        """Group the op list into (gemm, fused post-op chain) stages."""
        out: list[tuple[ProgramOp, list[ProgramOp]]] = []
        for op in self.ops:
            if op.kind in GEMM_OPS:
                out.append((op, []))
            else:
                out[-1][1].append(op)
        return out

    def summary(self) -> str:
        lines = [f"CrossbarProgram({self.net}): {len(self.ops)} FB ops, "
                 f"{self.n_mount_rounds} mount rounds"
                 + (" + dynamic mounts" if self.has_dynamic_stages else "")]
        taps = self.taps()
        for gemm, posts in self.stages():
            chain = "+".join([gemm.kind] + [p.kind for p in posts])
            mounts = (f"mounts {len(gemm.mount_rounds)}"
                      if gemm.kind == "gemm" else f"dyn[{gemm.dyn}]")
            tap = f" tap {taps[gemm.name]}" if gemm.name in taps else ""
            lines.append(
                f"  {gemm.name:14s} {chain:32s} "
                f"tile {gemm.tile_rows}x{gemm.tile_cols} {mounts}{tap}")
        return "\n".join(lines)


def _fb_fields(plan: ArrayPlan, kinds: tuple[str, ...]) -> dict:
    b = plan.block_of(*kinds) if kinds else None
    if b is None:
        return {}
    return {"fb_row0": b.row0, "fb_col0": b.col0,
            "fb_rows": b.rows, "fb_cols": b.cols}


def _mount_rounds(K: int, N: int, tile_rows: int,
                  tile_cols: int) -> tuple[MountRound, ...]:
    rounds = []
    rid = 0
    for kt in range(math.ceil(K / tile_rows)):
        for nt in range(math.ceil(N / tile_cols)):
            rounds.append(MountRound(
                rid, kt * tile_rows, min(K, (kt + 1) * tile_rows),
                nt * tile_cols, min(N, (nt + 1) * tile_cols)))
            rid += 1
    return tuple(rounds)


def _is_seq_group(group) -> bool:
    """Linear/attention heads, and CNN heads with sequence FBs other
    than a conv's closing layer norm (which the sequence path rejects)."""
    conv = group[0].kind == "conv"
    return (group[0].kind in ("linear", "attention")
            or any(l.kind in SEQ_KINDS
                   and not (conv and l.kind == "layernorm") for l in group))


def _seq_posts(group, head_dst: str, readable: set[str],
               ops: list[ProgramOp]) -> str:
    """Emit the sequence group's post-op chain; returns the final buffer.
    A residual reads a buffer of ``readable`` (finals and taps)."""
    rank = -1
    cur = head_dst
    for l in group[1:]:
        if l.kind not in POST_RANK:
            raise ValueError(f"unsupported FB op {l.kind} ({l.name})")
        if POST_RANK[l.kind] <= rank:
            raise ValueError(
                f"group {group[0].name}: {l.kind} out of canonical FB "
                "chain order (residual -> relu|gelu -> pool -> "
                "layernorm -> seqpool -> softmax)")
        rank = POST_RANK[l.kind]
        extra: dict = {}
        if l.kind == "residual":
            if l.residual_from not in readable:
                raise ValueError(f"{l.name} residual source "
                                 f"{l.residual_from!r} not materialized")
            extra = {"res_src": l.residual_from}
        if l.kind == "layernorm":
            extra = {"param": l.name}
        ops.append(ProgramOp(
            kind=l.kind, name=l.name, src=cur, dst=l.name,
            out_ch=l.features_out, seq=True, **extra))
        cur = l.name
    return cur


def _lower_seq_group(group, chip: ChipConfig, finals: set[str], prev: str,
                     ops: list[ProgramOp], taps: set[str]) -> str:
    """Lower one sequence group; returns its final buffer name.  Its
    input is a final buffer, a residual's addend a final or a tap."""
    head = group[0]
    planes = chip.weight_planes
    reserve = sum(_SEQ_FB_ROWS[l.kind] for l in group[1:]
                  if l.kind in _SEQ_FB_ROWS)
    src = head.input_from or prev
    if src not in finals:
        raise ValueError(f"{head.name} consumes unknown buffer {src!r}")

    def seq_gemm(name, src, dst, *, K, N, w_key="w", b_key="b",
                 param=None, rows_reserve=reserve):
        tile_rows = max(1, min(K, chip.array_rows - rows_reserve))
        tile_cols = max(1, min(N, chip.array_cols // planes))
        return ProgramOp(
            kind="gemm", name=name, src=src, dst=dst,
            param=head.name if param is None else param, w_key=w_key,
            b_key=b_key, seq=True, out_ch=N, tile_rows=tile_rows,
            tile_cols=tile_cols,
            mount_rounds=_mount_rounds(K, N, tile_rows, tile_cols))

    if head.kind == "linear":
        ops.append(seq_gemm(head.name, src, head.name,
                            K=head.features_in, N=head.features_out))
        return _seq_posts(group, head.name, finals | taps, ops)

    if head.kind != "attention":
        # raw LayerSpec lists can still reach here (the builder rejects
        # this at build time): sequence FBs have no CNN-head lowering
        raise ValueError(
            f"group head {head.name} is a {head.kind} but its chain has "
            "sequence FBs; gelu/layernorm/seqpool fuse onto linear or "
            "attention group heads only")
    d, h = head.features_in, head.heads
    hd = d // h
    qkv, scores = f"{head.name}@qkv", f"{head.name}@scores"
    probs, ctx = f"{head.name}@probs", f"{head.name}@ctx"
    # 1. fused qkv projection: one compile-time weight mount, N = 3D
    ops.append(seq_gemm(qkv, src, qkv, K=d, N=3 * d,
                        w_key="wqkv", b_key="bqkv", rows_reserve=0))
    # 2. Q·Kᵀ scores: dynamic K-operand mount, softmax FB fused with the
    #    1/sqrt(hd) logit scale; contraction length is the head dim
    ops.append(ProgramOp(
        kind="dyn_gemm", name=scores, src=qkv, dst=scores, dyn="qk",
        dyn_src=qkv, heads=h, seq=True,
        post_scale=attn_scale(hd),
        tile_rows=max(1, min(hd, chip.array_rows
                             - _SEQ_FB_ROWS["softmax"])),
        tile_cols=max(1, chip.array_cols // planes)))
    ops.append(ProgramOp(kind="softmax", name=probs, src=scores, dst=probs,
                         seq=True))
    # 3. P·V context: dynamic V-operand mount; the contraction length is
    #    the RUNTIME sequence length, so only a row budget exists here —
    #    the executor sizes the K grid to seq_len (dynamic block
    #    activation), N = head dim
    ops.append(ProgramOp(
        kind="dyn_gemm", name=ctx, src=probs, dst=ctx, dyn="pv",
        dyn_src=qkv, heads=h, seq=True,
        tile_rows=max(1, chip.array_rows - _SEQ_OR_ROWS),
        tile_cols=max(1, min(hd, chip.array_cols // planes))))
    # 4. output projection: compile-time weights again; the graph-level
    #    post-ops (residual/layernorm/...) fuse onto this stage
    ops.append(seq_gemm(head.name, ctx, head.name, K=d, N=d,
                        w_key="wo", b_key="bo"))
    return _seq_posts(group, head.name, finals | taps, ops)


def compile_network(net, *, config=None,
                    chip: ChipConfig | None = None,
                    cfg: CrossbarConfig | None = None,
                    name: str = "") -> CrossbarProgram:
    """Lower a network (name, LayerSpec list, or NetworkGraph) to a program.

    ``config`` is a ``repro_torch.api.HurryConfig`` — the unified front-door
    config from which both the chip geometry and the crossbar numerics
    derive (one derivation point).  Passing ``chip``/``cfg`` directly
    remains supported; a missing ``cfg`` comes from the chip's own
    ``ChipConfig.crossbar`` derivation rather than being re-derived
    here.
    """
    if config is not None:
        chip = chip or config.chip()
        cfg = cfg or config.crossbar()
    chip = chip or ChipConfig()
    cfg = cfg or chip.crossbar()
    if isinstance(net, str):
        # lazy: the registry lives in repro_torch.api.zoo, which sits
        # above this module
        from repro_torch.api.zoo import GRAPHS
        name = name or net
        layers = list(GRAPHS[net]().layers)
    elif hasattr(net, "layers"):          # a NetworkGraph
        layers = list(net.layers)
        name = name or net.name
    else:
        layers = list(net)
        name = name or "custom"
    planes = chip.weight_planes

    ops: list[ProgramOp] = []
    plans: list[ArrayPlan] = []
    finals: set[str] = {"input"}
    taps: set[str] = set()          # earlier groups' taps (residuals only)
    prev = "input"
    for group in layer_groups(layers):
        head = group[0]
        if _is_seq_group(group):
            cur = _lower_seq_group(group, chip, finals, prev, ops, taps)
            prev = cur
            finals.add(cur)
            if tap := group_tap(group):
                taps.add(tap)
            continue
        if head.kind not in ("conv", "fc"):
            raise ValueError(f"group head {head.name} is {head.kind}, "
                             "expected a GEMM layer")
        reqs, consumes, _ = build_group_requests(group, chip)
        plan = plan_array(reqs, chip.array_rows, chip.array_cols, consumes,
                          name=head.name)
        plans.append(plan)

        K = max(head.gemm_rows, 1)
        N = max(head.gemm_cols_logical, 1)
        tile_rows = reqs[0].req_rows
        tile_cols = max(1, reqs[0].req_cols // planes)

        src = head.input_from or prev
        if src not in finals:
            raise ValueError(f"{head.name} consumes unknown buffer {src!r}")
        ops.append(ProgramOp(
            kind="gemm", name=head.name, src=src, dst=head.name,
            param=head.name, is_conv=head.kind == "conv",
            ksize=head.ksize, stride=head.stride, padding=head.padding,
            out_hw=head.out_hw, out_ch=N, tile_rows=tile_rows,
            tile_cols=tile_cols,
            mount_rounds=_mount_rounds(K, N, tile_rows, tile_cols),
            **_fb_fields(plan, ("conv", "fc"))))

        rank = -1
        cur = head.name
        for l in group[1:]:
            if l.kind not in POST_RANK:
                raise ValueError(f"unsupported FB op {l.kind} ({l.name})")
            if POST_RANK[l.kind] <= rank:
                raise ValueError(
                    f"group {head.name}: {l.kind} out of canonical FB "
                    "chain order (residual -> relu -> pool -> softmax)")
            rank = POST_RANK[l.kind]
            extra: dict = {}
            if l.kind in ("maxpool", "avgpool"):
                if l.ksize != l.stride:
                    raise ValueError(
                        f"{l.name}: only window == stride pooling maps "
                        "onto the FB column tiling")
                extra = {"window": l.ksize, "in_hw": l.in_hw,
                         "out_hw": l.out_hw}
            if l.kind == "residual":
                if l.residual_from not in finals | taps:
                    raise ValueError(f"{l.name} residual source "
                                     f"{l.residual_from!r} not materialized")
                extra = {"res_src": l.residual_from}
            if l.kind == "layernorm":       # tokens: the conv's pixels
                if any(p.kind in ("maxpool", "avgpool") for p in group):
                    raise ValueError(f"{l.name}: a conv group's layer norm "
                                     "cannot follow a pool")
                extra = {"param": l.name, "seq": True}
            ops.append(ProgramOp(
                kind=l.kind, name=l.name, src=cur, dst=l.name,
                out_ch=l.out_ch or l.features_out, **extra,
                **_fb_fields(plan, _FB_KIND.get(l.kind, ()))))
            cur = l.name
        prev = cur
        finals.add(cur)
        if tap := group_tap(group):
            taps.add(tap)

    logits = next(op.dst for op in reversed(ops) if op.kind == "gemm")
    if hasattr(net, "input_shape"):       # a NetworkGraph carries its spec
        ihw, ich, ifeat = net.in_hw, net.in_ch, net.in_features
        iseq = getattr(net, "in_seq", 0)
    else:
        ihw, ich, ifeat, iseq = input_spec(layers)
    return CrossbarProgram(net=name, cfg=cfg, ops=tuple(ops),
                           plans=tuple(plans), input="input",
                           output=ops[-1].dst, logits=logits,
                           in_hw=ihw, in_ch=ich, in_features=ifeat,
                           in_seq=iseq)
