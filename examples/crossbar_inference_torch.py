"""Quantized CNN inference through the HURRY crossbar functional model.

    PYTHONPATH=src python examples/crossbar_inference_torch.py \\
        [--net resnet18] [--batch 8] [--noise 0.3] [--device cpu]

The PyTorch/CUDA port's counterpart of ``examples/crossbar_inference.py``.
Runs the same network in float32 and through the bit-sliced 1-bit-cell
crossbar (int8, 9-bit ADC, optional read noise) and reports logit
agreement: the functional side of the paper's "~1.86% accuracy drop"
claim (section IV-B2).  Weights come from a generator seeded 1, the input
from one seeded 0 (both on the CPU, so every device sees the same
numbers), the read noise from one seeded 9 on the device.

What it adds to the JAX example: the branch each GEMM of the clean
forward takes and the ``crossbar_gemm`` kernel launches per forward.
Noise-free 8-bit GEMMs go through the kernel (on a GPU, one launch
each): the exact branch where a ``rows``-row chunk cannot clip the ADC,
the sliced branch where it can (the default 512 rows against a 9-bit
ADC's 511, so wherever K reaches 512).  The noisy forward computes the
plain sliced model on the device and launches no kernel.
``main(argv)`` returns the numbers it prints.
"""

import argparse
import time

import torch

from repro_torch import trace
from repro_torch.core.crossbar import CrossbarConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import clip_possible
from repro_torch.models.cnn import CNN_MODELS, make_crossbar_matmul
from repro_torch.program.serve import params_to


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _forward(net: str, params: dict, x: torch.Tensor, mm=None
             ) -> tuple[torch.Tensor, float]:
    """The net's forward (float32 without ``mm``) and its seconds."""
    kw = {} if mm is None else {"mm": mm}
    _sync(x.device)
    t0 = time.perf_counter()
    y = CNN_MODELS[net].forward(params, x, **kw)
    _sync(x.device)
    return y, time.perf_counter() - t0


def evaluate(net: str, params: dict, x: torch.Tensor, *,
             noise: float = 0.3, noise_seed: int = 9) -> dict:
    """The float32 forward and the clean and noisy crossbar forwards of
    ``net`` on ``x``'s device, with each crossbar forward's argmax
    agreement and relative logit error against float32, seconds,
    ``crossbar_gemm`` launches, and GEMMs per path taken (the kernel's
    branches, or the plain sliced model where there is noise)."""
    y_fp, fp_s = _forward(net, params, x)
    out = dict(fp32=dict(logits=y_fp, s=fp_s))
    for label, cfg in [("clean", CrossbarConfig()),
                       ("noisy", CrossbarConfig(noise_sigma_thermal=noise))]:
        gen = torch.Generator(x.device).manual_seed(noise_seed)
        xbar = make_crossbar_matmul(cfg, noise_generator=gen)
        ks = []

        def mm(a, w, bias=None):
            ks.append(w.shape[-2])
            return xbar(a, w, bias)
        before = trace.counters().get("launches.crossbar_gemm", 0)
        y, s = _forward(net, params, x, mm)
        if cfg.has_noise(gen):
            branches = {"plain sliced model": len(ks)}
        else:
            sliced = sum(clip_possible(min(cfg.rows, k), cfg.adc_bits)
                         for k in ks)
            branches = {"exact branch": len(ks) - sliced,
                        "sliced branch": sliced}
        out[label] = dict(
            logits=y, s=s, launches=trace.counters().get(
                "launches.crossbar_gemm", 0) - before,
            gemms=len(ks), branches=branches,
            agree=(y_fp.argmax(1) == y.argmax(1)).float().mean().item(),
            rel=(torch.linalg.norm(y - y_fp)
                 / torch.linalg.norm(y_fp)).item())
    return out


def inputs(net: str, batch: int, device) -> tuple[dict, torch.Tensor]:
    """The example's weights (a generator seeded 1) and input (seeded 0),
    drawn on the CPU and moved to ``device``."""
    params = params_to(CNN_MODELS[net].init(
        torch.Generator().manual_seed(1)), torch.device(device))
    x = torch.randn((batch, 32, 32, 3),
                    generator=torch.Generator().manual_seed(0))
    return params, x.to(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--net", default="alexnet",
                    choices=["alexnet", "vgg16", "resnet18"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--noise", type=float, default=0.3,
                    help="thermal read-noise sigma (analog counts)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    print("device:", torch.cuda.get_device_name(dev) if dev.type == "cuda"
          else dev)
    params, x = inputs(args.net, args.batch, dev)
    out = evaluate(args.net, params, x, noise=args.noise)
    for key, label in [("clean", "int8 crossbar (clean)"),
                       ("noisy", f"int8 crossbar (noise={args.noise})")]:
        r = out[key]
        print(f"{args.net:9s} {label:28s} argmax-agree {r['agree']:6.1%}  "
              f"logit rel-err {r['rel']:.3f}")
        print(f"{'':9s} {'':28s} {r['gemms']} GEMMs ("
              + ", ".join(f"{k} {n}" for k, n in r["branches"].items())
              + f"), crossbar_gemm launches {r['launches']}, "
              f"{r['s'] * 1e3:.1f} ms per forward")
    return dict(out, net=args.net, device=str(dev), batch=args.batch)


if __name__ == "__main__":
    main()
