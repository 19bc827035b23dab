"""Executor: run a packed ``CrossbarProgram`` on a batch.

The port of ``repro.program.execute``'s weight-mounted path.  Per GEMM
stage (``_static_stage``):

* one ``quantize_layout`` call makes the GEMM's left operand from the
  stage input: the patches of a conv (``im2col``'s), an NHWC flatten for
  a spatial buffer entering an fc, or the tokens, quantized to symmetric
  int8 (the only quantization in the hot loop: weights were mounted by
  ``pack.pack_program``) straight into the kernel layout
  (``kernels.crossbar_gemm.kernel_layout``) of the stage's
  ``pack.layout_k``, which the stage's mounted ``wt`` shares: the
  logical K padded to a multiple of 32 where no ADC clip is possible,
  the full mounts chunk by chunk where one is; and the requant factor
  from the mount's ``w_amax`` (``core.crossbar.dequant_scale``'s form)
  beside it.  The zero K bytes the operand still carries are counted in
  ``layout.zero_k_bytes`` (``ZERO_K_BYTES``), and on the exact branch
  the bytes of it the GEMM's plan loads (``kernels.crossbar_gemm.
  x_load_bytes``: once a column tile) in ``gemm.x_load_bytes``
  (``X_LOAD_BYTES``).  Where the call reduces one amax over every element
  of a buffer an epilogue wrote (``kernels.quantize_layout.
  takes_partials``: rows of the buffer whole, or a conv whose windows
  read every pixel, on the multi-pass path), it takes the partial maxima
  of ``|buffer|`` that epilogue left in place of its own amax pass;
* one ``crossbar_gemm`` call activates every mount of the stage (each K
  chunk of ``tile_rows`` rows is one array read), on ``wt`` and that K;
* one ``fb_epilogue`` call runs the whole post-op chain (requant, bias,
  residual, ReLU, pooling, softmax) over the int32 GEMM output; where
  the stage has a tap (``CrossbarProgram.taps``: a pre-norm block's
  residual sum, which a later residual reads), the same call stores it
  beside the normalized rows as the stage's second output, its bytes
  counted in ``fb.tap_bytes`` (``TAP_BYTES``); where a later weight
  stage takes its output that way (``readers``), the same call leaves
  the partial maxima (``fb_epilogue(..., partials=True)``), kept beside
  the buffer in ``bufs`` (``parts_key``) and dropped after the last
  stage that may take them.

The bytes the ``quantize_layout`` calls' own amax passes read are
counted in ``layout.amax_pass_bytes`` (``AMAX_PASS_BYTES``).  Like the
kernel wrappers' launches, these counters (``repro_torch.trace``) count
what ran: each eager run, and each replay of a captured graph.

Dynamic-operand (attention) stages (``_dyn_stage``) mount runtime
activations instead of weights, per (batch, head) slice, in four kernel
calls for all slices (the counterpart of the JAX executor's ``jax.vmap``,
the contraction sized to the runtime head dim or sequence length):

* one ``quantize_layout`` call mounts the Q·Kᵀ or P·V right-hand
  operand at ``weight_bits`` (what ``plane_pack`` and the pad to the
  kernel layout compute), read K-major as it lies in the fused
  projection: the K heads, or V's transposed heads;
* one ``quantize_layout`` call quantizes the left-hand operand (the Q
  heads, or the probabilities), each slice with its own scale, and
  writes the requant factor from the right operand's per-slice amax:
  the plain product of the two quantize scales, which XLA does not
  reassociate under ``jax.vmap``;
* one batched ``crossbar_gemm`` call and one batched ``fb_epilogue``
  call (no bias; the context stored with its heads merged, and its
  partial maxima left where the projection takes them).

Each stage runs in a ``stage`` span (``repro_torch.trace``; its attrs
``layer``, the stage's GEMM layer, and ``tap``, its tap or ``""``), and
with ``plan=`` a list ``execute_packed`` appends the stage's
``PlanStep``: its layer, its tap, and what it counted (the wrappers'
launches and ``quantize_layout``'s device kernels on a CUDA run, which a
CPU run does not count, and the bytes).  ``Executable`` keeps the plan of
its warm-up.

Buffers are dropped as soon as no later stage reads them (a tap after
the stage of its residual; the partial maxima beside a buffer after its
last weight stage).  On a CUDA device the three calls launch
the hand-written kernels; on the CPU they take their plain PyTorch
versions.  ``execute_program`` is the
params-consuming entry: it packs under the call, then runs
``execute_packed``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch.kernels.crossbar_gemm import (call_layout, crossbar_gemm,
                                              x_load_bytes)
from repro_torch.kernels.fb_epilogue import fb_epilogue, split_outputs
from repro_torch.kernels.quantize_layout import (amax_pass_bytes,
                                                 quantize_layout,
                                                 takes_partials)

from .compile import CrossbarProgram, ProgramOp
from .pack import (PackedProgram, PackedStage, layout_k, logical_k,
                   pack_program)
from .sequence import qkv_head_views, tokens


# counter: the zero K bytes of the static stages' left operands, M * (Kk - K)
ZERO_K_BYTES = "layout.zero_k_bytes"
# counter: the bytes the epilogue's second stores (the taps) write
TAP_BYTES = "fb.tap_bytes"
# counter: the bytes of the exact static stages' left operands that the
# GEMM's plan loads into shared memory, once a column tile
X_LOAD_BYTES = "gemm.x_load_bytes"
# counter: the float32 bytes the quantize_layout calls' own amax passes read
AMAX_PASS_BYTES = "layout.amax_pass_bytes"


@dataclasses.dataclass(frozen=True)
class PlanStep:
    """One stage of a launch plan: its GEMM layer, ``counts``, what the
    stage counted (the growth of each ``repro_torch.trace`` counter over
    it: ``launches.<wrapper>``, ``device_kernels.quantize_layout``, the
    bytes), and ``tap``, the buffer its epilogue also stores, or
    ``""``."""

    layer: str
    counts: dict[str, int]
    tap: str = ""

    @classmethod
    def since(cls, layer: str, before: dict[str, int],
              tap: str = "") -> "PlanStep":
        """The step of what was counted since ``before`` (the
        ``trace.counters()`` of the stage's start)."""
        after = trace.counters()
        return cls(layer, {k: n - before.get(k, 0) for k, n in after.items()
                           if n != before.get(k, 0)}, tap)


def parts_key(name: str) -> str:
    """The ``bufs`` entry beside buffer ``name`` that holds the partial
    maxima of ``|bufs[name]|`` its epilogue left
    (``fb_epilogue(..., partials=True)``), where a later stage takes
    them.  It travels with the buffers (a copy of ``bufs`` carries it)
    and is dropped after the last stage that may take it."""
    return name + ":amax"


def _weight_readers(stages) -> dict[str, tuple[ProgramOp, ...]]:
    """Buffer name -> the weight stages that read it (those whose call
    may take its partial maxima)."""
    readers: dict[str, tuple[ProgramOp, ...]] = {}
    for gemm, _ in stages:
        if gemm.kind != "dyn_gemm":
            readers[gemm.src] = (*readers.get(gemm.src, ()), gemm)
    return readers


def _conv(gemm: ProgramOp) -> tuple[int, int, int] | None:
    return (gemm.ksize, gemm.stride, gemm.padding) if gemm.is_conv else None


def _wants_parts(readers: tuple[ProgramOp, ...], shape: tuple) -> bool:
    """Whether the epilogue writing a buffer of ``shape`` that
    ``readers`` read leaves its partial maxima: some reader's call on it
    takes them."""
    return any(takes_partials(shape, _conv(g)) for g in readers)


def _given_parts(bufs: dict, gemm: ProgramOp, xin: torch.Tensor) -> dict:
    """``{"partials": ...}`` where the epilogue that wrote the stage's
    input left them and the stage's call on ``xin`` takes them, else
    ``{}``."""
    parts = bufs.get(parts_key(gemm.src))
    if parts is None or not takes_partials(xin.shape, _conv(gemm)):
        return {}
    return {"partials": parts}


def _keep_parts(bufs: dict, name: str, parts: torch.Tensor | None) -> None:
    if parts is not None:
        bufs[parts_key(name)] = parts


def _quantize(x: torch.Tensor, K: int, **kw) -> tuple[torch.Tensor, ...]:
    """``quantize_layout``, the bytes of its own amax pass counted."""
    trace.count(AMAX_PASS_BYTES, amax_pass_bytes(x, K, **kw))
    return quantize_layout(x, K, **kw)


def im2col(x: torch.Tensor, k: int, stride: int, pad: int) -> torch.Tensor:
    """NHWC -> (N, OH, OW, C*k*k) patches in (C, kh, kw) order.

    One gather for the whole batch: the padded input is viewed as its
    windows (``Tensor.unfold`` over H, then W: (N, OH, OW, C, kh, kw))
    and copied once into rows in the patch order of JAX's
    ``conv_general_dilated_patches``, which ``pack_weight``'s
    ``permute(2, 0, 1, 3)`` layout matches.  Two launches at most (the
    zero pad, the copy), whatever the batch.  The executor no longer
    calls it (``quantize_layout`` gathers the patches itself); the
    functional CNN model does.
    """
    n, h, w, c = x.shape
    oh = (h + 2 * pad - k) // stride + 1
    ow = (w + 2 * pad - k) // stride + 1
    if pad:
        x = F.pad(x, (0, 0, pad, pad, pad, pad))
    windows = x.unfold(1, k, stride).unfold(2, k, stride)
    return windows.reshape(n, oh, ow, c * k * k)


def _last_reads(stages) -> dict[str, int]:
    """Buffer name -> index of the last stage that reads it (the
    partial maxima beside a buffer, ``parts_key``: of the last weight
    stage that reads it)."""
    last: dict[str, int] = {}
    for si, (gemm, posts) in enumerate(stages):
        last[gemm.src] = si
        if gemm.kind != "dyn_gemm":
            last[parts_key(gemm.src)] = si
        if gemm.dyn_src:
            last[gemm.dyn_src] = si
        for op in posts:
            if op.kind == "residual":
                last[op.res_src] = si
    return last


def dyn_mounts(gemm: ProgramOp, bufs: dict, cfg
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int,
                          int]:
    """A dynamic stage's operands, mounted slice by slice.

    Returns ``(a8 (S, M, Kk) int8, wt (S, N, Kk) int8, scale (S, 1, 1)
    f32, rows, K_pad)``, what ``jax.vmap`` over the JAX executor's
    per-slice function computes, laid out for the kernel.  ``wt`` is the
    right operand from one ``quantize_layout`` call at ``weight_bits``
    on its K-major view (Q·Kᵀ: the K heads, (B, H, T, hd); P·V: V's
    transposed heads, (B, H, hd, T), a stride of 3D along k), one amax a
    slice: ``plane_pack``'s planes in the kernel layout of K_pad, the
    contraction padded to whole ``rows``-row mounts.  ``a8`` and the
    requant factor come from a second call on the left operand (the Q
    heads as they lie in the fused projection, or the probabilities),
    given the first call's amax: ``scale`` is the plain product
    ``quantize_scale(a_amax) * quantize_scale(w_amax)``.  Views only
    besides the two calls.
    """
    if gemm.dyn == "qk":
        q, k, _ = qkv_head_views(tokens(bufs[gemm.src]), gemm.heads)
        a, wk = q, k                             # Kᵀ K-major: the K heads
    elif gemm.dyn == "pv":
        a = bufs[gemm.src]                       # (BH, T, T) probabilities
        _, _, v = qkv_head_views(tokens(bufs[gemm.dyn_src]), gemm.heads)
        wk = v.mT                                # (B, H, hd, T): V K-major
    else:  # pragma: no cover - compile_network emits only qk/pv
        raise ValueError(gemm.dyn)
    rows = min(gemm.tile_rows, a.shape[-1])      # dynamic mount height
    K = -(-a.shape[-1] // rows) * rows           # full mounts
    layout = dict(rows=rows, adc_bits=cfg.adc_bits, per_slice=True)
    wt, w_amax = _quantize(wk, K, bits=cfg.weight_bits, **layout)
    a8, _, scale = _quantize(a, K, bits=cfg.input_bits, w_amax=w_amax,
                             weight_bits=cfg.weight_bits, **layout)
    return a8.flatten(0, -3), wt.flatten(0, -3), scale, rows, K


def _dyn_stage(gemm: ProgramOp, posts: list[ProgramOp], bufs: dict,
               cfg, *, readers: dict | None = None) -> torch.Tensor:
    """One dynamic-operand GEMM stage (attention Q·Kᵀ or P·V): the
    slices' mounts (``dyn_mounts``), then one crossbar GEMM launch and
    one epilogue launch for all of them, the context stored with its
    heads merged, (B, T, heads * hd), its partial maxima kept in ``bufs``
    where a weight stage of ``readers`` (buffer name -> the weight stages
    that read it) takes them."""
    a8, wt, scale, rows, K = dyn_mounts(gemm, bufs, cfg)
    y = crossbar_gemm(a8, adc_bits=cfg.adc_bits, rows=rows, wt=wt, K=K)
    heads = gemm.heads if gemm.dyn == "pv" else 0
    dst = posts[-1].dst if posts else gemm.dst
    S, M, N = y.shape
    want = _wants_parts((readers or {}).get(dst, ()),
                        (S // heads, M, heads * N) if heads else (S, M, N))
    out, _, parts = split_outputs(fb_epilogue(
        y, scale, None, None, softmax=any(p.kind == "softmax" for p in posts),
        post_scale=gemm.post_scale, heads=heads, partials=want),
        partials=want)
    _keep_parts(bufs, dst, parts)
    return out


def _static_stage(gemm: ProgramOp, posts: list[ProgramOp],
                  st: PackedStage, bufs: dict, cfg, *, drop_softmax: bool,
                  tap: str = "", readers: dict | None = None
                  ) -> tuple[str, torch.Tensor]:
    """One weight-mounted GEMM stage + fused epilogue -> (dst, buffer);
    with ``tap`` (a buffer of its chain) the epilogue's second output
    goes to ``bufs[tap]``.  The stage's call takes the partial maxima its
    input's epilogue left in ``bufs`` where it may (``_given_parts``), and
    its own epilogue leaves them where a weight stage of ``readers``
    (buffer name -> the weight stages that read it) takes them."""
    src = bufs[gemm.src]
    b = src.shape[0]
    t = 0
    conv = None
    if gemm.is_conv:
        xin, conv = src, (gemm.ksize, gemm.stride, gemm.padding)
    elif gemm.seq:
        src = tokens(src)
        t = src.shape[1]
        xin = src.reshape(-1, src.shape[-1])
    else:
        xin = src.reshape(b, -1) if src.dim() == 4 else src   # NHWC flatten

    # the weight was laid out for the kernel at pack time (``st.wt``, at
    # ``layout_k``); quantize the activations straight into that layout
    # (the patches of a conv gathered on the way), the requant factor
    # (``dequant_scale``'s form) written beside them
    K = layout_k(gemm, cfg.adc_bits)
    xq, _, scale = _quantize(
        xin, K, bits=cfg.input_bits, rows=gemm.tile_rows,
        adc_bits=cfg.adc_bits, conv=conv, w_amax=st.w_amax,
        weight_bits=cfg.weight_bits, **_given_parts(bufs, gemm, xin))
    trace.count(ZERO_K_BYTES,
                xq.shape[0] * (xq.shape[-1] - logical_k(gemm)))
    if call_layout(K, gemm.tile_rows, cfg.adc_bits).exact:
        trace.count(X_LOAD_BYTES, x_load_bytes(1, xq.shape[0],
                                               st.wt.shape[-2],
                                               xq.shape[-1]))
    y_int = crossbar_gemm(xq, adc_bits=cfg.adc_bits, rows=gemm.tile_rows,
                          wt=st.wt, K=K)

    act, pool, window, img_hw, norm = "none", "none", 0, 0, "none"
    softmax, res = False, None
    out_hw = gemm.out_hw
    dst = posts[-1].dst if posts else gemm.dst
    for op in posts:
        if op.kind == "relu":
            act = "relu"
        elif op.kind == "gelu":
            act = "gelu"
        elif op.kind == "layernorm":
            norm = "layer"
        elif op.kind == "residual":
            r = bufs[op.res_src]
            res = r.reshape(-1, r.shape[-1]).contiguous()
        elif op.kind in ("maxpool", "avgpool"):
            pool = "max" if op.kind == "maxpool" else "avg"
            window, img_hw, out_hw = op.window, op.in_hw, op.out_hw
        elif op.kind == "seqpool":
            pool, window = "seqmean", t
        elif op.kind == "softmax":
            softmax = True
        else:  # pragma: no cover - compile_network validates kinds
            raise ValueError(op.kind)
    if softmax and drop_softmax:
        softmax = False
        dst = gemm.dst
    shape = ((b, out_hw, out_hw, y_int.shape[-1])
             if gemm.is_conv and norm == "none" else tuple(y_int.shape))
    want = pool == "none" and _wants_parts((readers or {}).get(dst, ()),
                                           shape)
    out, tapped, parts = split_outputs(fb_epilogue(
        y_int, scale, st.bias, res, act=act, pool=pool, window=window,
        img_hw=img_hw, softmax=softmax, norm=norm, gamma=st.ln_g,
        beta=st.ln_b, tap=bool(tap), partials=want), tap=bool(tap),
        partials=want)
    _keep_parts(bufs, dst, parts)
    if tap:
        trace.count(TAP_BYTES, tapped.numel() * tapped.element_size())
        bufs[tap] = (tapped.reshape(b, out_hw, out_hw, -1) if gemm.is_conv
                     else tapped.reshape(b, t, -1))
    if gemm.is_conv and norm == "none":
        out = out.reshape(b, out_hw, out_hw, -1)
    elif gemm.is_conv:                   # a layer norm's tokens
        out = out.reshape(b, out_hw * out_hw, -1)
    elif gemm.seq and pool != "seqmean":
        out = out.reshape(b, t, -1)
    return dst, out


def execute_packed(packed: PackedProgram, x: torch.Tensor, *,
                   return_logits: bool = False,
                   plan: list | None = None) -> torch.Tensor:
    """Run a packed program on a batch ``x`` (B, H, W, C) float32 — or
    (B, F) features for fc-first programs, (B, T, D) tokens for
    sequence-input programs — on ``x``'s device.

    Returns the program's output buffer (softmax probabilities), or the
    pre-softmax logits with ``return_logits=True`` (the final stage is
    fused without its softmax FB).  With ``plan`` (a list) each stage's
    ``PlanStep`` is appended to it, in order.
    """
    program = packed.program
    cfg = program.cfg
    bufs: dict[str, torch.Tensor] = {program.input: x}
    stages = program.stages()
    readers = _weight_readers(stages)
    last = _last_reads(stages)
    taps = program.taps()
    ret = program.logits if return_logits else program.output
    for si, ((gemm, posts), st) in enumerate(zip(stages, packed.stages)):
        before = trace.counters() if plan is not None else None
        tap = taps.get(gemm.name, "")
        with trace.span("stage", layer=gemm.name, tap=tap):
            if gemm.kind == "dyn_gemm":
                dst = posts[-1].dst if posts else gemm.dst
                bufs[dst] = _dyn_stage(gemm, posts, bufs, cfg,
                                       readers=readers)
            else:
                dst, out = _static_stage(
                    gemm, posts, st, bufs, cfg,
                    drop_softmax=return_logits and si == len(stages) - 1,
                    tap=tap, readers=readers)
                bufs[dst] = out
        if plan is not None:
            plan.append(PlanStep.since(gemm.name, before, tap))
        # drop buffers no later stage reads
        for name in [n for n, li in last.items() if li <= si]:
            if name != ret:
                bufs.pop(name, None)
                del last[name]
    return bufs[ret]


def execute_program(program: CrossbarProgram, params: dict, x: torch.Tensor,
                    *, block_m: int = 512, block_n: int = 512,
                    return_logits: bool = False) -> torch.Tensor:
    """Params-consuming compatibility entry (pre-packing cost profile).

    Packs ``params`` on their device under the call, so the weight
    planes are derived again on every call, which is what serving paid
    before compile-time mounting; servers pack once and call
    ``execute_packed`` (``ProgramServer`` and ``api.CompiledModel`` do).
    Numerics are ``execute_packed``'s.  ``block_m`` / ``block_n`` are
    the JAX package's Pallas tile sizes, accepted for parity: the CUDA
    kernels choose their own tiles.
    """
    del block_m, block_n        # accepted for parity; see the docstring
    return execute_packed(pack_program(program, params), x,
                          return_logits=return_logits)
