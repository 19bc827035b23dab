"""Operations and bytes of each stage, from the configuration's layer list.

A yardstick that later changes to the program cannot move: the shapes
are the layers' logical ones (a conv's K is ``k * k * in_ch``, a linear's
its input features), never the program's buffers, whose padding and
layout are the program's choice.  The bound of a call is the larger of
its bytes over the HBM rate and its int8 operations over the int8 peak,
with every input byte read once and every output byte written once.

A GEMM layer becomes the stages the program runs for it: one weight
stage for a conv, fc or linear; four for an attention (the fused qkv
projection, the scores Q·Kᵀ and the context P·V per (image, head)
slice, the output projection).  Each stage is one ``quantize_layout``
call (two for a scores or context stage: the right operand, then the
left), one ``crossbar_gemm`` call and one ``fb_epilogue`` call.
"""

from __future__ import annotations

import dataclasses

from bench.harness.layers import GEMM_KINDS, Layer, covered, flat, tokens

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA's data sheet
INT8_OPS_PER_S = 1979e12         # dense int8 tensor-core peak
WRAPPERS = ("quantize_layout", "crossbar_gemm", "fb_epilogue")


@dataclasses.dataclass(frozen=True)
class Stage:
    """One stage of a forward, per image: ``S`` slices of an (M, K) x
    (K, N) product; ``quant_in`` float32 elements the left operand's
    quantize reads (the covered input), ``right_in`` the right operand's
    (a scores or context stage's, quantized at run time: else 0, the
    weight being mounted once); the epilogue's extra reads (``res`` a
    residual of the output's size, ``vec`` per-column vectors:
    bias, layer-norm gain and shift) and its ``out_rows`` per slice."""

    name: str
    S: int
    M: int
    K: int
    N: int
    quant_in: int
    right_in: int = 0
    res: bool = False
    vec: int = 0
    out_rows: int = 0


def _chain(layers: list[Layer], i: int) -> list[Layer]:
    """The functional blocks that follow GEMM layer ``i`` and fuse into
    its stage."""
    out, cur = [], layers[i].name
    for l in layers[i + 1:]:
        if l.kind in GEMM_KINDS or l.src != cur:
            break
        out.append(l)
        cur = l.name
    return out


def stages(layers: list[Layer]) -> list[Stage]:
    """Every stage of one image's forward."""
    out = []
    for i, l in enumerate(layers):
        if l.kind not in GEMM_KINDS:
            continue
        posts = _chain(layers, i)
        res = any(p.kind == "residual" for p in posts)
        vec = 1 + 2 * any(p.kind == "layernorm" for p in posts)
        if l.kind == "conv":
            sp = l.spec
            hw, c = l.shape_in[1], l.shape_in[2]
            cov = len(covered(hw, sp["k"], sp["stride"], sp["pad"]))
            M, K, N = l.shape_out[1] ** 2, sp["k"] ** 2 * c, sp["out"]
            quant_in = cov * cov * c
        elif l.kind == "fc":
            M, K, N = 1, flat(l.shape_in), l.spec["out"]
            quant_in = K
        elif l.kind == "linear":
            _, T, D = tokens(l.shape_in)
            M, K, N = T, D, l.spec["out"]
            quant_in = T * D
        else:                                        # attention
            _, T, D = tokens(l.shape_in)
            H = l.spec["heads"]
            hd = D // H
            out += [Stage(f"{l.name}@qkv", 1, T, D, 3 * D, T * D, vec=1,
                          out_rows=T),
                    Stage(f"{l.name}@scores", H, T, hd, T, T * D,
                          right_in=T * D, out_rows=T),
                    Stage(f"{l.name}@ctx", H, T, T, hd, H * T * T,
                          right_in=T * D, out_rows=T)]
            M, K, N = T, D, D
            quant_in = T * D
        rows = M
        for p in posts:
            if p.kind in ("maxpool", "avgpool"):
                rows = p.shape_out[1] ** 2
            elif p.kind == "seqpool":
                rows = 1
        out.append(Stage(l.name, 1, M, K, N, quant_in, res=res, vec=vec,
                         out_rows=rows))
    return out


def macs_per_image(layers: list[Layer]) -> int:
    """Multiply-accumulates of one image's forward: every GEMM at its
    logical shape, the attention products included."""
    return sum(s.S * s.M * s.K * s.N for s in stages(layers))


def stage_bytes(s: Stage, batch: int) -> dict[str, int]:
    """Bytes each wrapper moves for stage ``s`` over a batch: each input
    read once, each output written once."""
    S = s.S * batch                   # slices in the batch
    if s.right_in:
        # two calls: the right operand (its int8 mount and an amax a
        # slice), then the left one (its amax, the right one's read, the
        # requant factor a slice)
        q = (4 * s.right_in * batch + s.K * s.N * S + 4 * S
             + 4 * s.quant_in * batch + s.M * s.K * S + 12 * S)
        weight, scales = s.K * s.N * S, 4 * S
    else:
        # the amax, the mount's amax and the requant factor
        q = 4 * s.quant_in * batch + s.M * s.K * S + 12
        weight, scales = s.K * s.N, 4
    gemm = s.M * s.K * S + weight + 4 * s.M * s.N * S
    fb = (4 * s.M * s.N * S * (2 if s.res else 1) + 4 * s.N * s.vec
          + scales + 4 * s.out_rows * s.N * S)
    return {"quantize_layout": q, "crossbar_gemm": gemm, "fb_epilogue": fb}


def bound_s(layers: list[Layer], batch: int) -> dict[str, float]:
    """The least device seconds of each wrapper's calls in one forward
    of ``batch`` images: per call, the larger of bytes over the HBM rate
    and operations over the int8 peak, summed over the stages."""
    out = dict.fromkeys(WRAPPERS, 0.0)
    for s in stages(layers):
        by = stage_bytes(s, batch)
        ops = {"crossbar_gemm": 2 * s.S * batch * s.M * s.K * s.N}
        for w in WRAPPERS:
            out[w] += max(by[w] / HBM_BYTES_PER_S,
                          ops.get(w, 0) / INT8_OPS_PER_S)
    return out
