"""Weight packing: mount every stage's weights once, at compile time.

The port of ``repro.program.pack``.  ``pack_program`` is the numeric
analogue of programming the crossbar conductances: per GEMM stage it
quantizes the full weight matrix to symmetric int8 (``plane_pack``),
applies the conv im2col layout (``w.permute(2, 0, 1, 3)``, patch order
(C, kh, kw)), zero-pads K up to ``n_mounts * tile_rows`` so the kernel's
chunks are exactly the stage's mount rounds, and keeps the f32 weight
``amax`` from which the executor derives the requant factor.  The int8
planes and ``amax`` equal the JAX package's bit for bit.

Packing runs on the device the parameters live on; the hot loop then
only quantizes activations.  Dynamic-operand (attention) stages own no
weights and pack as empty placeholders.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.crossbar import quantize_symmetric

from .compile import CrossbarProgram


@dataclasses.dataclass(frozen=True)
class PackedStage:
    """One GEMM stage's chip-resident weights.

    ``w8`` is the int8 mount-plane matrix ``(K_padded, N)``; ``w_amax``
    the 0-d f32 ``max(|w|)``; ``bias`` the f32 per-column bias;
    ``ln_g``/``ln_b`` the fused layer-norm FB's gamma/beta (``None``
    without one).  Dynamic-operand stages hold 0-sized placeholders.
    """

    w8: torch.Tensor
    w_amax: torch.Tensor
    bias: torch.Tensor
    ln_g: torch.Tensor | None = None
    ln_b: torch.Tensor | None = None


def dyn_placeholder(device) -> PackedStage:
    """The empty PackedStage of a dynamic-operand (attention) stage."""
    return PackedStage(w8=torch.zeros(0, 0, dtype=torch.int8, device=device),
                       w_amax=torch.zeros((), device=device),
                       bias=torch.zeros(0, device=device))


@dataclasses.dataclass(frozen=True)
class PackedProgram:
    """A ``CrossbarProgram`` with weights mounted at pack time.

    ``program`` is the plan-free program (the executor never reads the
    array plans); ``stages`` holds one ``PackedStage`` per GEMM stage,
    in ``program.stages()`` order.
    """

    stages: tuple[PackedStage, ...]
    program: CrossbarProgram

    @property
    def cfg(self):
        return self.program.cfg


def plane_pack(w: torch.Tensor, *, tile_rows: int,
               weight_bits: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """Mount a (K, N) float matrix: -> (int8 planes (K_pad, N), f32 amax).

    Symmetric per-tensor int8 quantization at ``weight_bits``, K
    zero-padded up to the next ``tile_rows`` multiple so every mount is
    a full ADC row chunk (zero rows add nothing to any bitline count).
    """
    wq, _ = quantize_symmetric(w, weight_bits)
    wq = F.pad(wq, (0, 0, 0, -w.shape[0] % tile_rows))
    return wq.to(torch.int8), w.abs().amax().float()


def pack_weight(w: torch.Tensor, *, is_conv: bool, tile_rows: int,
                weight_bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Float weight -> (int8 mount planes (K_pad, N), f32 amax)."""
    if is_conv:                 # (k, k, in_ch, out_ch) -> (in_ch*k*k, N)
        kk = w.shape[0] * w.shape[1] * w.shape[2]
        w = w.permute(2, 0, 1, 3).reshape(kk, -1)
    return plane_pack(w, tile_rows=tile_rows, weight_bits=weight_bits)


def pack_program(program: CrossbarProgram, params: dict) -> PackedProgram:
    """Mount ``params`` (layer -> key -> float tensor) into ``program``.

    Runs once, outside the per-call hot path (``api.compile`` packs at
    compile time), on the device the parameters live on.
    """
    cfg = program.cfg
    device = next(t.device for p in params.values() for t in p.values())
    stages = []
    for gemm, posts in program.stages():
        if gemm.kind == "dyn_gemm":
            stages.append(dyn_placeholder(device))
            continue
        p = params[gemm.param]
        w8, amax = pack_weight(p[gemm.w_key].float(), is_conv=gemm.is_conv,
                               tile_rows=gemm.tile_rows,
                               weight_bits=cfg.weight_bits)
        ln = next((o for o in posts if o.kind == "layernorm"), None)
        lp = params[ln.param] if ln is not None else None
        stages.append(PackedStage(
            w8=w8, w_amax=amax,
            bias=p[gemm.b_key].float().contiguous(),
            ln_g=None if lp is None else lp["g"].float().contiguous(),
            ln_b=None if lp is None else lp["b"].float().contiguous()))
    return PackedProgram(stages=tuple(stages),
                         program=dataclasses.replace(program, plans=()))
