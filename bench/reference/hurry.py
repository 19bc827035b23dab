"""The plain reference: a HURRY crossbar network, layer by layer.

Plain PyTorch, on whatever device its inputs are.  It reads the
configuration's layer list (``bench.harness.layers``), the float
weights and the images, and works out everything else again: the
weights' symmetric quantization, every activation's, the integer
products, the requant factors and the functional-block chain.  It
imports nothing of the program.

The semantics (HURRY, arXiv:2409.16640, sections II-III, and the JAX
reproduction it is held to):

* Every GEMM quantizes its left operand per tensor over the whole batch
  (an attention product: per (image, head) slice) and its weight per
  tensor, symmetric: ``scale = max(amax, 1e-8) * f32(1/qmax)``, the
  reciprocal form jitted XLA compiles ``/ qmax`` into; values are
  ``clip(round_half_even(x / scale), -qmax - 1, qmax)`` with a correctly
  rounded division.  A conv's amax runs over the pixels some patch
  reads.
* The crossbar product: weights and inputs in two's-complement bit
  planes, each (input bit, weight bit) plane pair summed per mount of at
  most ``array_rows`` rows on a bitline and digitized by an
  ``adc_bits`` ADC.  A GEMM followed by functional blocks shares its
  arrays with them, so its mounts hold fewer than ``array_rows`` rows;
  where no count can pass the ADC's range, the product is the integer
  GEMM (``_clip_free``), computed here in float64, exact below 2^53.
  Configurations whose ADC can clip are refused.
* The requant factor of a weight stage is ``(max(xa, 1e-8) * max(wa,
  1e-8)) * f32(f32(1/qx) * f32(1/qw))``, the form XLA folds the product
  of the two scales into; an attention product's is the plain product
  of the two scales, slice by slice.  The dequant ``y * scale + bias``
  rounds once (a fused multiply-add).
* Functional blocks in float32 as the graph lists them: residual add,
  ReLU, tanh-GELU, layer norm (eps 1e-5), window max and average pools
  (a window summed in row-major order, then times ``f32(1/k^2)``), the
  token mean, and a max-subtracted softmax; attention scores are scaled
  by ``f32(1/sqrt(head_dim))`` before their softmax.

``forward(..., act=torch.bfloat16)`` stores every functional block's
output in bfloat16 instead of float32: the lower-precision control that
the correctness check must reject.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from bench.harness.layers import GEMM_KINDS, Layer, covered

AMAX_FLOOR = 1e-8
LN_EPS = 1e-5
GELU_C = 0.7978845608028654          # sqrt(2 / pi)
BLOCK_ELEMS = 1 << 27                # float64 patch elements a GEMM block


def qmax(bits: int) -> int:
    return (1 << (bits - 1)) - 1


def _inv(bits: int) -> float:
    return float(np.float32(1.0 / qmax(bits)))


def scale_of(amax: torch.Tensor, bits: int) -> torch.Tensor:
    return torch.clamp_min(amax, AMAX_FLOOR) * _inv(bits)


def quantize(x: torch.Tensor, amax: torch.Tensor, bits: int) -> torch.Tensor:
    """Symmetric quantization to ``bits`` as float values; ``amax`` is a
    0-d tensor, or (S,) for a (S, ...) stack of slices."""
    s = scale_of(amax, bits).reshape(-1, *([1] * (x.dim() - 1))) \
        if amax.dim() else scale_of(amax, bits)
    q = qmax(bits)
    return torch.round(x / s).clamp_(-q - 1, q)


def requant_static(xa: torch.Tensor, wa: torch.Tensor, ib: int,
                   wb: int) -> torch.Tensor:
    c = float(np.float32(_inv(ib)) * np.float32(_inv(wb)))
    return (torch.clamp_min(xa, AMAX_FLOOR)
            * torch.clamp_min(wa, AMAX_FLOOR)) * c


def dequant(y: torch.Tensor, scale: torch.Tensor,
            bias: torch.Tensor | None) -> torch.Tensor:
    """``fma(f32(y), scale, bias)``, one rounding (exact in float64)."""
    out = y.float().double() * scale.double()
    return (out if bias is None else out + bias.double()).float()


def _clip_free(K: int, has_posts: bool, hurry: dict) -> None:
    rows = min(K, hurry["array_rows"] - (1 if has_posts else 0))
    if rows > (1 << hurry["adc_bits"]) - 1:
        raise NotImplementedError(
            f"a {rows}-row mount can pass a {hurry['adc_bits']}-bit ADC's "
            "range: the reference covers clip-free configurations only")


def gelu(x):
    return 0.5 * x * (1.0 + torch.tanh(GELU_C * (x + 0.044715 * x * x * x)))


def layer_norm(x, g, b):
    m = x.mean(dim=-1, keepdim=True)
    d = x - m
    v = (d * d).mean(dim=-1, keepdim=True)
    return d / torch.sqrt(v + LN_EPS) * g + b


def softmax(x):
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _mm(a8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """Integer product of float-valued int operands, exact (float64)."""
    return a8.double() @ w8.double()


class Reference:
    """A configuration's network on given weights (``params``, the
    program's layouts), with the functional blocks' outputs stored in
    ``act`` (float32, or bfloat16 for the control)."""

    def __init__(self, layers: list[Layer], hurry: dict, params: dict,
                 act: torch.dtype = torch.float32):
        self.layers = layers
        self.h = hurry
        self.p = params
        self.act = act
        # a GEMM with a functional block after it shares its arrays
        # with the block, so its mounts hold fewer than array_rows rows
        self.posts = {a.name: b.src == a.name and b.kind not in GEMM_KINDS
                      for a, b in zip(layers, layers[1:])}

    def _r(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.act == torch.float32 else t.to(self.act).float()

    # -- weight stages ----------------------------------------------------
    def _weights(self, w: torch.Tensor):
        wa = w.abs().amax()
        return quantize(w, wa, self.h["weight_bits"]), wa

    def _static(self, x2: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                posts: bool) -> torch.Tensor:
        ib, wb = self.h["input_bits"], self.h["weight_bits"]
        _clip_free(w.shape[0], posts, self.h)
        xa = x2.abs().amax()
        w8, wa = self._weights(w)
        x8 = quantize(x2, xa, ib)
        rows = max(1, BLOCK_ELEMS // max(1, x8.shape[1]))
        y = torch.cat([_mm(x8[i:i + rows], w8)
                       for i in range(0, x8.shape[0], rows)])
        return self._r(dequant(y, requant_static(xa, wa, ib, wb), b))

    def _conv(self, l: Layer, x: torch.Tensor) -> torch.Tensor:
        sp, p = l.spec, self.p[l.name]
        k, s, pad = sp["k"], sp["stride"], sp["pad"]
        B, H, W, C = x.shape
        ib, wb = self.h["input_bits"], self.h["weight_bits"]
        K = C * k * k
        _clip_free(K, self.posts.get(l.name, False), self.h)
        rows = torch.tensor(covered(H, k, s, pad), device=x.device)
        cols = torch.tensor(covered(W, k, s, pad), device=x.device)
        xa = x.index_select(1, rows).index_select(2, cols).abs().amax()
        x8 = quantize(x, xa, ib)
        w8, wa = self._weights(p["w"].permute(2, 0, 1, 3).reshape(K, -1))
        oh = l.shape_out[1]
        per = max(1, BLOCK_ELEMS // (oh * oh * K))
        ys = []
        for i in range(0, B, per):
            blk = x8[i:i + per].permute(0, 3, 1, 2).double()
            patches = F.unfold(blk, k, padding=pad, stride=s)  # (b, K, L)
            ys.append(_mm(patches.transpose(1, 2).reshape(-1, K), w8))
        y = torch.cat(ys).reshape(B, oh, oh, -1)
        return self._r(dequant(y, requant_static(xa, wa, ib, wb), p["b"]))

    # -- attention -------------------------------------------------------
    def _dyn(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Per-slice product a (S, M, K) x w (S, K, N), both operands
        quantized slice by slice (w at ``weight_bits``), dequantized by
        the plain product of the scales."""
        ib, wb = self.h["input_bits"], self.h["weight_bits"]
        _clip_free(a.shape[-1], True, self.h)
        aa = a.abs().amax(dim=(-2, -1))
        wa = w.abs().amax(dim=(-2, -1))
        y = _mm(quantize(a, aa, ib), quantize(w, wa, wb))
        scale = scale_of(aa, ib) * scale_of(wa, wb)
        return dequant(y, scale[:, None, None], None)

    def _attention(self, l: Layer, x: torch.Tensor) -> torch.Tensor:
        p, H = self.p[l.name], l.spec["heads"]
        B, T, D = x.shape
        hd = D // H
        qkv = self._static(x.reshape(B * T, D), p["wqkv"], p["bqkv"],
                           False).reshape(B, T, 3, H, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2).reshape(B * H, T, hd)
                   for i in range(3))
        scores = self._r(self._dyn(q, k.transpose(1, 2)))
        scores = self._r(scores * float(np.float32(1.0 / math.sqrt(hd))))
        probs = self._r(softmax(scores))
        ctx = self._r(self._dyn(probs, v))
        ctx = ctx.reshape(B, H, T, hd).transpose(1, 2).reshape(B * T, D)
        return self._static(ctx, p["wo"], p["bo"],
                            self.posts.get(l.name, False)).reshape(B, T, D)

    # -- the network -----------------------------------------------------
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Images (B, H, W, C) float32 -> the network's output (B, N):
        softmax probabilities where the graph ends in a softmax."""
        bufs = {"input": x}
        cur = x
        for l in self.layers:
            src = bufs[l.src]
            if l.kind == "conv":
                y = self._conv(l, src)
            elif l.kind == "fc":
                p = self.p[l.name]
                y = self._static(src.reshape(src.shape[0], -1), p["w"],
                                 p["b"], self.posts.get(l.name, False))
            elif l.kind == "linear":
                p = self.p[l.name]
                t = _tok(src)
                y = self._static(t.reshape(-1, t.shape[-1]), p["w"], p["b"],
                                 self.posts.get(l.name, False)).reshape(
                                     t.shape[0], t.shape[1], -1)
            elif l.kind == "attention":
                y = self._attention(l, _tok(src))
            elif l.kind == "relu":
                y = torch.relu(src)
            elif l.kind == "gelu":
                y = self._r(gelu(src))
            elif l.kind == "layernorm":
                p = self.p[l.name]
                y = self._r(layer_norm(_tok(src), p["g"], p["b"]))
            elif l.kind == "residual":
                r = bufs[l.spec["source"]]
                y = self._r(src + (_tok(r) if src.dim() == 3 else r))
            elif l.kind == "maxpool":
                k = l.spec["k"]
                B, Hh, W, C = src.shape
                y = src.reshape(B, Hh // k, k, W // k, k, C).amax(dim=(2, 4))
            elif l.kind == "avgpool":
                k = l.spec["k"]
                B, Hh, W, C = src.shape
                x6 = src.reshape(B, Hh // k, k, W // k, k, C)
                acc = torch.zeros_like(x6[:, :, 0, :, 0])
                for i in range(k):
                    for j in range(k):
                        acc = acc + x6[:, :, i, :, j]
                y = self._r(acc * float(np.float32(1.0) / np.float32(k * k)))
            elif l.kind == "seqpool":
                y = self._r(_tok(src).mean(dim=1))
            elif l.kind == "softmax":
                y = self._r(softmax(src))
            else:
                raise ValueError(f"{l.name}: unknown kind {l.kind!r}")
            bufs[l.name] = cur = y
        return cur.float()


def _tok(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1, x.shape[-1]) if x.dim() == 4 else x
