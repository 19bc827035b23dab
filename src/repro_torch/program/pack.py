"""Weight packing: mount every stage's weights once, at compile time.

The port of ``repro.program.pack``.  ``pack_program`` is the numeric
analogue of programming the crossbar conductances: per GEMM stage it
quantizes the full weight matrix to symmetric int8 (``plane_pack``),
applies the conv im2col layout (``w.permute(2, 0, 1, 3)``, patch order
(C, kh, kw)), zero-pads K up to ``n_mounts * tile_rows`` so that the
planes are exactly the stage's mount rounds, and keeps the f32 weight
``amax`` from which the executor derives the requant factor.  The int8
planes and ``amax`` equal the JAX package's bit for bit.  Beside them it
lays the planes out once for the CUDA kernel (``PackedStage.wt``,
``mount_stage``: the planes transposed, K-major, at the stage's
``layout_k``), a derived copy that nothing compares or saves.

``layout_k`` is the contraction length both of a static stage's
``crossbar_gemm`` operands are laid out at.  On the exact branch (no ADC
clip possible) it is the logical K, so the layout pads only to a
multiple of 32: the zero rows of whole mounts would add nothing to an
int32 sum, and the executor neither writes nor multiplies them.  On the
sliced branch it is the full mounts' K, each ``tile_rows`` chunk padded
to a multiple of 32 rows, because the chunk boundaries decide what an
ADC read sums and clips.

Packing runs on the device the parameters live on; the hot loop then
only quantizes activations.  Dynamic-operand (attention) stages own no
weights and pack as empty placeholders; the executor mounts their
runtime operands with ``kernels.quantize_layout``, which computes what
``plane_pack`` over a slice axis computes, straight in the kernel layout.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.crossbar import quantize_scale, quantize_with_scale
from repro_torch.kernels.crossbar_gemm import call_layout, mount_weight

from .compile import CrossbarProgram, ProgramOp


@dataclasses.dataclass(frozen=True)
class PackedStage:
    """One GEMM stage's chip-resident weights.

    ``w8`` is the int8 mount-plane matrix ``(K_padded, N)``; ``w_amax``
    the 0-d f32 ``max(|w|)``; ``bias`` the f32 per-column bias;
    ``ln_g``/``ln_b`` the fused layer-norm FB's gamma/beta (``None``
    without one).  ``wt`` is the kernel-layout weight derived from ``w8``
    (``mount_stage``: (N, Kk) int8, K-major; on the exact branch the
    logical K rows padded to a multiple of 32, on the sliced one all
    K_padded rows chunk by chunk); it is not compared and not saved.
    Dynamic-operand stages hold 0-sized placeholders and no ``wt``.
    """

    w8: torch.Tensor
    w_amax: torch.Tensor
    bias: torch.Tensor
    ln_g: torch.Tensor | None = None
    ln_b: torch.Tensor | None = None
    wt: torch.Tensor | None = dataclasses.field(default=None, compare=False,
                                                repr=False)


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


def plane_pack(w: torch.Tensor, *, tile_rows: int, weight_bits: int = 8
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mount a (K, N) float matrix: -> (int8 planes (K_pad, N), f32 amax).

    Symmetric per-tensor int8 quantization at ``weight_bits``, K
    zero-padded up to the next ``tile_rows`` multiple so every mount is
    a full ADC row chunk (zero rows add nothing to any bitline count).
    A (S, K, N) stack of runtime operands mounts slice by slice, in one
    pass: one int8 plane matrix and one ``amax`` per slice, -> ((S,
    K_pad, N), (S,)), what ``plane_pack`` under ``jax.vmap`` computes.
    """
    amax = w.abs().amax(dim=(-2, -1))
    scale = quantize_scale(amax, weight_bits)[..., None, None]
    wq = quantize_with_scale(w, scale, weight_bits)
    wq = F.pad(wq, (0, 0, 0, -w.shape[-2] % tile_rows))
    return wq.to(torch.int8), amax.float()


def pack_weight(w: torch.Tensor, *, is_conv: bool, tile_rows: int,
                weight_bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Float weight -> (int8 mount planes (K_pad, N), f32 amax)."""
    if is_conv:                 # (k, k, in_ch, out_ch) -> (in_ch*k*k, N)
        kk = w.shape[0] * w.shape[1] * w.shape[2]
        w = w.permute(2, 0, 1, 3).reshape(kk, -1)
    return plane_pack(w, tile_rows=tile_rows, weight_bits=weight_bits)


def logical_k(gemm: ProgramOp) -> int:
    """A static stage's contraction length: the last mount round's
    ``k1`` (C*k*k for a conv, the input features for an fc)."""
    return gemm.mount_rounds[-1].k1


def layout_k(gemm: ProgramOp, adc_bits: int) -> int:
    """The K a static stage's ``crossbar_gemm`` operands are laid out at
    (module docstring): ``logical_k`` where a call at the full mounts' K
    takes the exact branch (``call_layout``), the full mounts' K where
    it takes the sliced one."""
    k = logical_k(gemm)
    full = -(-k // gemm.tile_rows) * gemm.tile_rows
    return k if call_layout(full, gemm.tile_rows, adc_bits).exact else full


def mount_stage(gemm: ProgramOp, w8: torch.Tensor,
                adc_bits: int) -> torch.Tensor:
    """A static stage's ``PackedStage.wt``: the first ``layout_k`` rows
    of its planes ``w8`` (K_padded, N) in the kernel layout
    (``mount_weight``).  ``pack_program`` and the loader of saved models
    both mount through it."""
    return mount_weight(w8[:layout_k(gemm, adc_bits)], rows=gemm.tile_rows,
                        adc_bits=adc_bits)


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
            wt=mount_stage(gemm, w8, cfg.adc_bits),
            bias=p[gemm.b_key].float().contiguous(),
            ln_g=None if lp is None else lp["g"].float().contiguous(),
            ln_b=None if lp is None else lp["b"].float().contiguous()))
    return PackedProgram(stages=tuple(stages),
                         program=dataclasses.replace(program, plans=()))
