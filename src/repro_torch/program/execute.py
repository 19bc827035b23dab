"""Executor: run a packed ``CrossbarProgram`` on a batch.

The port of ``repro.program.execute``'s weight-mounted path.  Per GEMM
stage (``_static_stage``):

* the stage input becomes the GEMM's left operand (``im2col`` for convs,
  an NHWC flatten for a spatial buffer entering an fc);
* it is quantized to symmetric int8 (the only quantization in the hot
  loop: weights were mounted by ``pack.pack_program``) and zero-padded
  to the mounts' K;
* one ``crossbar_gemm`` call activates every mount of the stage (each K
  chunk of ``tile_rows`` rows is one array read);
* one ``fb_epilogue`` call runs the whole post-op chain (requant, bias,
  residual, ReLU, pooling, softmax) over the int32 GEMM output.

Buffers are dropped as soon as no later stage reads them.  On a CUDA
device both calls launch the hand-written kernels; on the CPU they take
their plain PyTorch versions.  Dynamic-operand (attention) stages are
the next slice of the port and raise ``NotImplementedError`` here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.crossbar import (dequant_scale, quantize_scale,
                                       quantize_with_scale)
from repro_torch.kernels.crossbar_gemm import crossbar_gemm
from repro_torch.kernels.fb_epilogue import fb_epilogue

from .compile import ProgramOp
from .pack import PackedProgram, PackedStage
from .sequence import tokens


def im2col(x: torch.Tensor, k: int, stride: int, pad: int) -> torch.Tensor:
    """NHWC -> (N, OH, OW, C*k*k) patches in (C, kh, kw) order.

    ``F.unfold`` on NCHW yields the patch order of JAX's
    ``conv_general_dilated_patches``, which ``pack_weight``'s
    ``permute(2, 0, 1, 3)`` layout matches.
    """
    n, h, w, c = x.shape
    oh = (h + 2 * pad - k) // stride + 1
    ow = (w + 2 * pad - k) // stride + 1
    cols = F.unfold(x.permute(0, 3, 1, 2), (k, k), padding=pad,
                    stride=stride)                      # (N, C*k*k, L)
    return cols.transpose(1, 2).reshape(n, oh, ow, c * k * k)


def _last_reads(stages) -> dict[str, int]:
    """Buffer name -> index of the last stage that reads it."""
    last: dict[str, int] = {}
    for si, (gemm, posts) in enumerate(stages):
        last[gemm.src] = si
        if gemm.dyn_src:
            last[gemm.dyn_src] = si
        for op in posts:
            if op.kind == "residual":
                last[op.res_src] = si
    return last


def _static_stage(gemm: ProgramOp, posts: list[ProgramOp],
                  st: PackedStage, bufs: dict, cfg, *,
                  drop_softmax: bool) -> tuple[str, torch.Tensor]:
    """One weight-mounted GEMM stage + fused epilogue -> (dst, buffer)."""
    src = bufs[gemm.src]
    b = src.shape[0]
    t = 0
    if gemm.is_conv:
        cols = im2col(src, gemm.ksize, gemm.stride, gemm.padding)
        xin = cols.reshape(-1, cols.shape[-1])
    elif gemm.seq:
        src = tokens(src)
        t = src.shape[1]
        xin = src.reshape(-1, src.shape[-1])
    else:
        xin = src.reshape(b, -1) if src.dim() == 4 else src   # NHWC flatten

    x_amax = xin.abs().amax()
    xq = quantize_with_scale(xin, quantize_scale(x_amax, cfg.input_bits),
                             cfg.input_bits).to(torch.int8)
    kp = st.w8.shape[0] - xq.shape[1]
    if kp:   # K was padded to full mounts at pack time; mirror it
        xq = F.pad(xq, (0, kp))
    y_int = crossbar_gemm(xq.contiguous(), st.w8, adc_bits=cfg.adc_bits,
                          rows=gemm.tile_rows)
    scale = dequant_scale(x_amax, st.w_amax, cfg.input_bits,
                          cfg.weight_bits).reshape(1, 1)

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
    out = fb_epilogue(y_int, scale, st.bias, res, act=act, pool=pool,
                      window=window, img_hw=img_hw, softmax=softmax,
                      norm=norm, gamma=st.ln_g, beta=st.ln_b)
    if gemm.is_conv:
        out = out.reshape(b, out_hw, out_hw, -1)
    elif gemm.seq and pool != "seqmean":
        out = out.reshape(b, t, -1)
    return dst, out


def execute_packed(packed: PackedProgram, x: torch.Tensor, *,
                   return_logits: bool = False) -> torch.Tensor:
    """Run a packed program on a batch ``x`` (B, H, W, C) float32 — or
    (B, F) features for fc-first programs — on ``x``'s device.

    Returns the program's output buffer (softmax probabilities), or the
    pre-softmax logits with ``return_logits=True`` (the final stage is
    fused without its softmax FB).
    """
    program = packed.program
    cfg = program.cfg
    bufs: dict[str, torch.Tensor] = {program.input: x}
    stages = program.stages()
    last = _last_reads(stages)
    ret = program.logits if return_logits else program.output
    for si, ((gemm, posts), st) in enumerate(zip(stages, packed.stages)):
        if gemm.kind == "dyn_gemm":
            raise NotImplementedError(
                f"{program.net}: stage {gemm.name} is a dynamic-operand "
                "(attention) GEMM; the port runs weight-mounted CNN "
                "programs, and attention stages (_dyn_stage) are its next "
                "slice")
        dst, out = _static_stage(
            gemm, posts, st, bufs, cfg,
            drop_softmax=return_logits and si == len(stages) - 1)
        bufs[dst] = out
        # drop buffers no later stage reads
        for name in [n for n, li in last.items() if li <= si]:
            if name != ret:
                bufs.pop(name, None)
                del last[name]
    return bufs[ret]
