"""Functional model of a ReRAM crossbar performing bit-sliced analog GEMM.

The port of ``repro.core.crossbar``: the array configuration, the
symmetric int8 quantizers, and the functional GEMM with its read-noise
model (paper §II, §IV-A1).  Weights and inputs are decomposed into
two's-complement bit planes; per (input bit, weight bit) plane pair and
chunk of ``rows`` rows, a bitline integrates a non-negative count that
the ADC digitizes into ``[0, 2^adc_bits - 1]``; shift-and-add (SnA)
recombines the planes, the MSB planes weighing negative.

``crossbar_matmul`` dispatches statically, as the JAX function does:

* **exact** — no chunk can saturate the ADC (``cfg.clip_free`` or
  ``K <= cfg.adc_max``) and read noise is off: one integer GEMM over the
  two's-complement-wrapped operands, bit-identical to the sliced model;
* **sliced** — otherwise: input planes stacked along M and weight planes
  along N, one batched float32 product of {0, 1} planes per chunk (exact:
  counts <= rows < 2^24, also under TF32, whose 10-bit mantissa holds 0
  and 1), ADC noise and clip on the counts, SnA in int64.

With 8-bit inputs and weights and no noise (the paper's and every zoo
config's case) the call goes through ``kernels.crossbar_gemm`` on the
wrapped int8 operands, which computes the same function with the same
``rows = min(rows, K)`` rule: on a CUDA tensor that is one launch of the
hand-written kernel, on a CPU tensor the kernel's plain version.  Other
bit widths (whose planes the kernel's 8-plane expansion would clip
wrongly) and calls with read noise compute the plain PyTorch version
above on the tensor's own device.

**Noise.** ``jax.random.normal(noise_key, ...)`` has no torch
counterpart, so the port takes a ``torch.Generator`` (on the operands'
device) where the JAX function takes ``noise_key``: the same model, other
draws.

**Numerics.** The JAX package runs its quantizers under ``jax.jit``, and
XLA rewrites two expressions that an eager port must reproduce to stay
bit-identical:

* a division by a constant becomes a multiplication by its float32
  reciprocal: ``amax / 127`` is computed as ``amax * f32(1/127)``
  (``quantize_scale``);
* a product of two such scales is reassociated, the constants folding
  into one: ``(a / 127) * (b / 127)`` is computed as
  ``(a * b) * f32(f32(1/127) * f32(1/127))`` (``dequant_scale``).

``x / scale`` itself stays a true (correctly rounded) division, and
``torch.round`` rounds half to even like ``jnp.round``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.crossbar_gemm import crossbar_gemm
from repro_torch.kernels.fb_epilogue import dequant
# the quantizer's constants and scale live beside the kernel that
# quantizes the executor's activations, so both share one definition
from repro_torch.kernels.quantize_layout import AMAX_FLOOR as _AMAX_FLOOR
from repro_torch.kernels.quantize_layout import inv_qmax as _inv_qmax
from repro_torch.kernels.quantize_layout import qmax as _qmax
from repro_torch.kernels.quantize_layout import quantize_scale


@dataclasses.dataclass(frozen=True)
class CrossbarConfig:
    """Physical configuration of one unit ReRAM array."""

    rows: int = 512
    cols: int = 512
    cell_bits: int = 1          # HURRY uses single-bit cells (paper §II-B)
    adc_bits: int = 9           # 9-bit ADC for 512 rows (paper §II-A)
    dac_bits: int = 1           # bit-serial input streaming
    weight_bits: int = 8        # int8 quantized weights (paper §IV-A2)
    input_bits: int = 8         # int8 quantized activations
    # Read-noise model (std of the analog count before ADC rounding).
    noise_sigma_thermal: float = 0.0
    noise_sigma_shot: float = 0.0   # scaled by sqrt(count)

    @property
    def adc_max(self) -> int:
        return (1 << self.adc_bits) - 1

    @property
    def weight_planes(self) -> int:
        # ceil(weight_bits / cell_bits) planes, one column group per plane.
        return -(-self.weight_bits // self.cell_bits)

    @property
    def input_phases(self) -> int:
        # bit-serial phases per input value.
        return -(-self.input_bits // self.dac_bits)

    @property
    def clip_free(self) -> bool:
        """True iff ADC clipping can never fire (count <= rows <= adc_max).

        With 1-bit cells a bitline count is a sum of at most ``rows``
        {0,1} products, so ``rows <= 2^adc_bits - 1`` makes digitization
        exact and the bit-sliced pipeline equal to a plain int GEMM.
        ``crossbar_matmul`` refines this per call: a chunk also holds at
        most K rows, so ``K <= adc_max`` is equally clip-free.
        """
        return self.rows <= self.adc_max

    def has_noise(self, noise_generator) -> bool:
        """True iff the read-noise model perturbs counts for this call."""
        return noise_generator is not None and (
            self.noise_sigma_thermal > 0 or self.noise_sigma_shot > 0)


def _twos_complement_planes(v: torch.Tensor, bits: int
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Decompose signed ints into (planes, plane_weights).

    planes: (bits, *v.shape) of {0,1} int32; plane_weights: (bits,) int64
    with the MSB negative (two's complement recombination is exact for
    signed ints).
    """
    u = v.to(torch.int64) & ((1 << bits) - 1)
    planes = torch.stack([(u >> i) & 1 for i in range(bits)]).to(torch.int32)
    w = torch.tensor([1 << i for i in range(bits - 1)] + [-(1 << (bits - 1))],
                     dtype=torch.int64, device=v.device)
    return planes, w


def _wrap_signed(v: torch.Tensor, bits: int) -> torch.Tensor:
    """Two's-complement wrap to ``bits`` (int64): what plane decomposition
    + MSB-negative recombination computes for any int input.  Taken in
    int32 first, as the JAX function casts."""
    half = 1 << (bits - 1)
    return ((v.to(torch.int32).to(torch.int64) + half)
            & ((1 << bits) - 1)) - half


def _adc(count: torch.Tensor, cfg: CrossbarConfig,
         noise_generator: torch.Generator | None) -> torch.Tensor:
    """Digitize float32 analog bitline counts (with optional read noise)
    -> int32 codes in ``[0, adc_max]``."""
    if cfg.has_noise(noise_generator):
        sigma = cfg.noise_sigma_thermal + cfg.noise_sigma_shot * torch.sqrt(
            count.clamp_min(0.0))
        count = torch.round(count + sigma * torch.randn(
            count.shape, generator=noise_generator, device=count.device))
    return count.clamp(0, cfg.adc_max).to(torch.int32)


def _exact(x2: torch.Tensor, w: torch.Tensor,
           cfg: CrossbarConfig) -> torch.Tensor:
    """One integer GEMM over the wrapped operands, in float64 (exact while
    ``|sum| < 2^53``), wrapped to int32 as the JAX function's int32 dot."""
    y = (_wrap_signed(x2, cfg.input_bits).double()
         @ _wrap_signed(w, cfg.weight_bits).double())
    return y.to(torch.int64).to(torch.int32)


def _sliced(x2: torch.Tensor, w: torch.Tensor, cfg: CrossbarConfig,
            noise_generator: torch.Generator | None) -> torch.Tensor:
    """The plane-packed sliced model: (S, M, K) x (S, K, N) -> (S, M, N)."""
    S, M, K = x2.shape
    N = w.shape[-1]
    Bi, Bw, R = cfg.input_bits, cfg.weight_bits, cfg.rows
    xp, xs = _twos_complement_planes(x2, Bi)             # (Bi, S, M, K)
    wp, ws = _twos_complement_planes(w, Bw)              # (Bw, S, K, N)
    C = -(-K // R)
    xp = torch.nn.functional.pad(xp, (0, C * R - K))
    wp = torch.nn.functional.pad(wp, (0, 0, 0, C * R - K))
    # input planes along M, weight planes along N: (S, C, Bi*M, R) x
    # (S, C, R, Bw*N), one batched product over slices and chunks
    xp = (xp.reshape(Bi, S, M, C, R).permute(1, 3, 0, 2, 4)
          .reshape(S, C, Bi * M, R))
    wp = (wp.reshape(Bw, S, C, R, N).permute(1, 2, 3, 0, 4)
          .reshape(S, C, R, Bw * N))
    counts = _adc(xp.float() @ wp.float(), cfg, noise_generator)
    # SnA: digital and exact, in int64 (partial sums can pass 2^31)
    scale = xs[:, None] * ws[None, :]                    # (Bi, Bw)
    y = (counts.reshape(S, C, Bi, M, Bw, N).to(torch.int64)
         * scale[:, None, :, None]).sum(dim=(1, 2, 4))
    return y.to(torch.int32)


def crossbar_matmul(x: torch.Tensor, w: torch.Tensor,
                    cfg: CrossbarConfig = CrossbarConfig(),
                    noise_generator: torch.Generator | None = None
                    ) -> torch.Tensor:
    """Bit-sliced crossbar GEMM: (..., K) x (K, N) -> (..., N) in int32.

    Integer operands of any range are wrapped to ``cfg.input_bits`` /
    ``cfg.weight_bits`` (two's complement).  K is split into chunks of
    ``cfg.rows`` whose partial sums SnA combines digitally.  A (S, M, K) x
    (S, K, N) pair (a 3-D ``w``) runs S independent GEMMs, what
    ``jax.vmap`` over the JAX function computes, in one call.

    Dispatches as the module docstring says: noise-free 8-bit calls go
    through ``kernels.crossbar_gemm`` (one kernel launch on a CUDA
    tensor); the others compute the plain exact or sliced model on the
    tensor's device.  ``noise_generator`` (a ``torch.Generator`` on that
    device) draws the read noise when the config has any.
    """
    if w.dim() not in (2, 3) or (w.dim() == 3 and x.dim() != 3):
        raise ValueError(f"crossbar_matmul: shapes {tuple(x.shape)} x "
                         f"{tuple(w.shape)}; w is (K, N), or (S, K, N) "
                         "with x (S, M, K)")
    K, N = w.shape[-2:]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K) if w.dim() == 2 else x
    noisy = cfg.has_noise(noise_generator)
    if not noisy and cfg.input_bits == cfg.weight_bits == 8:
        y = crossbar_gemm(_wrap_signed(x2, 8).to(torch.int8),
                          _wrap_signed(w, 8).to(torch.int8),
                          adc_bits=cfg.adc_bits, rows=cfg.rows)
    elif (cfg.clip_free or K <= cfg.adc_max) and not noisy:
        y = _exact(x2, w, cfg)
    else:
        y = _sliced(x2.reshape(-1, *x2.shape[-2:]),
                    w.reshape(-1, K, N), cfg, noise_generator)
    return y.reshape(*lead, N)


def dequant_scale(x_amax: torch.Tensor, w_amax: torch.Tensor,
                  input_bits: int = 8, weight_bits: int = 8) -> torch.Tensor:
    """The shift-and-add requant factor ``x_scale * w_scale``.

    Written the way XLA reassociates ``quantize_scale(a) *
    quantize_scale(b)``: the two amax floors multiply first, then the
    folded float32 constant ``f32(1/qx) * f32(1/qw)``.
    """
    c = float(np.float32(_inv_qmax(input_bits))
              * np.float32(_inv_qmax(weight_bits)))
    return (torch.clamp_min(x_amax, _AMAX_FLOOR)
            * torch.clamp_min(w_amax, _AMAX_FLOOR)) * c


def quantize_with_scale(x: torch.Tensor, scale: torch.Tensor,
                        bits: int = 8) -> torch.Tensor:
    """``clip(round(x / scale), -qmax-1, qmax)`` as float values."""
    qmax = _qmax(bits)
    return torch.round(x / scale).clamp_(-qmax - 1, qmax)


def quantize_symmetric(x: torch.Tensor, bits: int = 8
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor quantization -> (int32 values, scale)."""
    scale = quantize_scale(x.abs().amax(), bits)
    return quantize_with_scale(x, scale, bits).to(torch.int32), scale


def crossbar_linear(x_fp: torch.Tensor, w_fp: torch.Tensor,
                    cfg: CrossbarConfig = CrossbarConfig(),
                    noise_generator: torch.Generator | None = None,
                    bias: torch.Tensor | None = None) -> torch.Tensor:
    """Quantize float inputs and weights, run the crossbar, dequantize.

    (..., K) x (K, N) quantizes each operand per tensor and requantizes by
    ``dequant_scale``, the form jitted XLA compiles the JAX function's
    ``xscale * wscale`` into; ``bias`` (N,) is added in the same rounding
    (``fma(y, scale, bias)``), as XLA fuses ``crossbar_linear(x, w) + b``.
    A (S, M, K) x (S, K, N) pair quantizes slice by slice (one ``amax``
    per slice of each operand, what ``jax.vmap`` over the JAX function
    computes), runs every slice in one ``crossbar_matmul`` and requantizes
    by the plain product ``xscale * wscale``, which XLA keeps under
    ``vmap``.
    """
    if w_fp.dim() == 3:
        xamax, wamax = x_fp.abs().amax(dim=(-2, -1)), w_fp.abs().amax(
            dim=(-2, -1))
        xscale = quantize_scale(xamax, cfg.input_bits)[:, None, None]
        wscale = quantize_scale(wamax, cfg.weight_bits)[:, None, None]
        scale = xscale * wscale
    else:
        xamax, wamax = x_fp.abs().amax(), w_fp.abs().amax()
        xscale = quantize_scale(xamax, cfg.input_bits)
        wscale = quantize_scale(wamax, cfg.weight_bits)
        scale = dequant_scale(xamax, wamax, cfg.input_bits, cfg.weight_bits)
    xq = quantize_with_scale(x_fp, xscale, cfg.input_bits)
    wq = quantize_with_scale(w_fp, wscale, cfg.weight_bits)
    y = crossbar_matmul(xq.to(torch.int32), wq.to(torch.int32), cfg,
                        noise_generator)
    if bias is None:
        return y.float() * scale
    return dequant(y, scale, bias)
