"""Crossbar array configuration and symmetric int8 quantization.

The port of ``repro.core.crossbar``'s configuration and quantizers.  The
bit-sliced functional ``crossbar_matmul`` (with read noise) is not part
of the port yet; the executor's GEMMs run on the ``crossbar_gemm``
kernel instead.

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

_AMAX_FLOOR = 1e-8


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
        """
        return self.rows <= self.adc_max

    def has_noise(self, noise_key) -> bool:
        """True iff the read-noise model perturbs counts for this call."""
        return noise_key is not None and (self.noise_sigma_thermal > 0
                                          or self.noise_sigma_shot > 0)


def _qmax(bits: int) -> int:
    return (1 << (bits - 1)) - 1


def _inv_qmax(bits: int) -> float:
    """``f32(1 / qmax)``: the constant XLA multiplies by for ``/ qmax``."""
    return float(np.float32(1.0 / _qmax(bits)))


def quantize_scale(amax: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Symmetric quantization scale from a per-tensor ``max(|x|)``.

    ``max(amax, 1e-8) * f32(1/qmax)``: the reciprocal form jitted XLA
    compiles ``max(amax, 1e-8) / qmax`` into (module docstring).
    """
    return torch.clamp_min(amax, _AMAX_FLOOR) * _inv_qmax(bits)


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
