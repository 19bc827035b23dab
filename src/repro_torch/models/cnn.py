"""Functional CNNs (AlexNet / VGG-16 / ResNet-18, CIFAR-10 variants).

The port of ``repro.models.cnn``.  Convolutions are expressed as im2col
+ GEMM so the *same* forward pass can route every GEMM through either a
float32 matmul (``fp_matmul``) or the HURRY crossbar functional model
(``make_crossbar_matmul``: int8 bit-sliced, with optional read noise):
that is how accuracy through the crossbar's numerics is measured rather
than assumed.  Param init shapes derive from the ``repro_torch.api.zoo``
builder graphs, and ``make_program_forward`` runs the same nets through
the compiled ``CrossbarProgram`` path.  Activations are NHWC and conv
weights ``(k, k, Cin, Cout)``, the JAX package's layouts, so its
parameters cross unchanged through ``convert.params_from_jax``.

**The GEMM hook.** Every GEMM goes through ``mm(x, w, bias=None)``,
which returns ``x @ w + bias``.  The JAX package calls ``mm(x, w)`` and
adds the bias after it; jitted XLA then fuses that add into the
crossbar's dequant multiply, one rounding.  The port hands the bias to
``mm`` so that the crossbar's ``mm`` can do the same in eager PyTorch.
``mm`` also takes a leading slice axis, (S, M, K) x (S, K, N) -> (S, M,
N), computing the S GEMMs independently (the crossbar's quantizing each
slice with its own scale): what ``jax.vmap(mm)`` computes for
attention's per-(batch, head) products.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.core.crossbar import CrossbarConfig, crossbar_linear
from repro_torch.kernels.fb_epilogue import avg_windows
from repro_torch.program.compile import compile_network
from repro_torch.program.execute import execute_packed, im2col
from repro_torch.program.pack import pack_program
from repro_torch.program.serve import params_to

MatmulFn = Callable[..., torch.Tensor]


def fp_matmul(x: torch.Tensor, w: torch.Tensor,
              bias: torch.Tensor | None = None) -> torch.Tensor:
    y = x @ w
    return y if bias is None else y + bias


def make_crossbar_matmul(cfg: CrossbarConfig | None = None,
                         noise_generator: torch.Generator | None = None
                         ) -> MatmulFn:
    """Route model GEMMs through the crossbar functional model.

    ``crossbar_matmul`` dispatches per config: clip-free and noise-free
    runs as one exact integer GEMM (``kernels.crossbar_gemm``'s exact
    branch for 8-bit operands), noisy or saturating configs take the
    faithful sliced path.  ``noise_generator`` draws the read noise.
    """
    cfg = cfg or CrossbarConfig()

    def mm(x, w, bias=None):
        return crossbar_linear(x, w, cfg, noise_generator, bias=bias)
    return mm


def make_program_forward(net, cfg: CrossbarConfig | None = None,
                         return_logits: bool = True, **compile_kw
                         ) -> Callable[[dict, torch.Tensor], torch.Tensor]:
    """Compile-then-execute forward: the scheduled program computes.

    Lowers ``net`` once through the scheduler (``program.compile``) and
    returns a ``forward(params, x)`` that packs ``params`` onto ``x``'s
    device and executes the program: every GEMM through
    ``crossbar_gemm``, every post-op chain through ``fb_epilogue``.
    ``return_logits=True`` mirrors the functional forward's output;
    ``False`` returns the softmax FB's probabilities.
    """
    program = compile_network(net, cfg=cfg, **compile_kw)

    def forward(params: dict, x: torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32)
        packed = pack_program(program, params_to(params, x.device))
        return execute_packed(packed, x, return_logits=return_logits)
    return forward


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int,
           pad: int, mm: MatmulFn) -> torch.Tensor:
    """w: (k, k, Cin, Cout) applied via im2col GEMM (NHWC)."""
    k = w.shape[0]
    cols = im2col(x, k, stride, pad)                    # (N,OH,OW,Cin*k*k)
    n, oh, ow, kk = cols.shape
    wm = w.permute(2, 0, 1, 3).reshape(kk, -1)          # (Cin*k*k, Cout)
    return mm(cols.reshape(-1, kk), wm, b).reshape(n, oh, ow, -1)


def maxpool(x: torch.Tensor, k: int = 2, stride: int = 2) -> torch.Tensor:
    """NHWC max pool, VALID windows."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, stride).permute(0, 2, 3, 1)


def _graph_init(net: str) -> Callable[..., dict]:
    """Param init whose shapes derive from the builder graph (the one
    source of truth for layer shapes; the keys are its GEMM layer
    names, which the forwards below index by)."""
    def init(generator: torch.Generator | None = None) -> dict:
        from repro_torch.api.zoo import GRAPHS   # lazy: api builds on models
        return GRAPHS[net]().init_params(generator)
    return init


# ---------------------------------------------------------------------------
# AlexNet (CIFAR)
# ---------------------------------------------------------------------------

def alexnet_forward(params: dict, x: torch.Tensor,
                    mm: MatmulFn = fp_matmul) -> torch.Tensor:
    pools_after = {1, 2, 5}
    for i in range(1, 6):
        p = params[f"conv{i}"]
        x = torch.relu(conv2d(x, p["w"], p["b"], 1, 1, mm))
        if i in pools_after:
            x = maxpool(x)
    x = x.reshape(x.shape[0], -1)
    x = torch.relu(mm(x, params["fc6"]["w"], params["fc6"]["b"]))
    x = torch.relu(mm(x, params["fc7"]["w"], params["fc7"]["b"]))
    return mm(x, params["fc8"]["w"], params["fc8"]["b"])


# ---------------------------------------------------------------------------
# VGG-16 (CIFAR)
# ---------------------------------------------------------------------------

_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512, "M"]


def vgg16_forward(params: dict, x: torch.Tensor,
                  mm: MatmulFn = fp_matmul) -> torch.Tensor:
    i = 1
    for v in _VGG_CFG:
        if v == "M":
            x = maxpool(x)
        else:
            p = params[f"conv{i}"]
            x = torch.relu(conv2d(x, p["w"], p["b"], 1, 1, mm))
            i += 1
    x = x.reshape(x.shape[0], -1)
    x = torch.relu(mm(x, params["fc1"]["w"], params["fc1"]["b"]))
    return mm(x, params["fc2"]["w"], params["fc2"]["b"])


# ---------------------------------------------------------------------------
# ResNet-18 (CIFAR)
# ---------------------------------------------------------------------------

_RESNET_STAGES = [(64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2)]


def resnet18_forward(params: dict, x: torch.Tensor,
                     mm: MatmulFn = fp_matmul) -> torch.Tensor:
    p = params["conv0"]
    x = torch.relu(conv2d(x, p["w"], p["b"], 1, 1, mm))
    for s, (ch, blocks, stage_stride) in enumerate(_RESNET_STAGES):
        for b in range(blocks):
            pre = f"s{s}b{b}"
            stride = stage_stride if b == 0 else 1
            res = x
            p1 = params[f"{pre}_conv1"]
            h = torch.relu(conv2d(x, p1["w"], p1["b"], stride, 1, mm))
            p2 = params[f"{pre}_conv2"]
            h = conv2d(h, p2["w"], p2["b"], 1, 1, mm)
            if f"{pre}_proj" in params:
                pp = params[f"{pre}_proj"]
                res = conv2d(x, pp["w"], pp["b"], stride, 0, mm)
            x = torch.relu(h + res)
    # the global average pool in the kernel's summation order, which does
    # not depend on the device (a ``mean`` reduction's does)
    n, h, w, c = x.shape
    x = avg_windows(x.reshape(n, 1, h, 1, w, c)).reshape(n, c)
    return mm(x, params["fc"]["w"], params["fc"]["b"])


@dataclasses.dataclass(frozen=True)
class CNNModel:
    init: Callable[..., dict]
    forward: Callable[..., torch.Tensor]


CNN_MODELS = {
    "alexnet": CNNModel(_graph_init("alexnet"), alexnet_forward),
    "vgg16": CNNModel(_graph_init("vgg16"), vgg16_forward),
    "resnet18": CNNModel(_graph_init("resnet18"), resnet18_forward),
}
