"""Serving launcher: continuous batched greedy decoding.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_8b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_8b \\
        --device cpu

The port of ``repro.launch.serve``, with the same flags plus
``--device`` (default: the GPU).  It compiles the decode step
(``repro_torch.serve.step.compile_decode_step``, as the JAX launcher
jits it: on the GPU one CUDA graph per key, captured in the first round
and replayed in every later one), runs a continuous-batching loop over
synthetic request traffic, and reports tokens/s and the captures.  As in
the JAX launcher, ``--reduced`` is on by default and cannot be switched
off here: full-width serving goes through the library, ``lm.init_params(cfg,
generator, dtype=torch.bfloat16, device="cuda")`` and
``serve.step.greedy_generate`` (``chip_smoke.py`` serves Qwen3-8B so).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serve.step import compile_decode_step


def main(argv: list[str] | None = None) -> dict:
    """Serve ``--rounds`` rounds; returns the tokens served, the seconds
    and the number of decode executables captured."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2_1_8b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    gen = torch.Generator(dev).manual_seed(0)
    params = lm.init_params(cfg, gen, device=dev)
    decode = compile_decode_step(cfg)
    enc = None
    if cfg.is_encdec:
        enc = torch.randn((args.batch, cfg.encoder_seq, cfg.d_model),
                          generator=gen, device=dev).to(torch.bfloat16)
    positions = torch.arange(args.new_tokens, dtype=torch.int32, device=dev)

    total_tok = 0
    t0 = time.time()
    for r in range(args.rounds):          # continuous batching: new batch
        caches = lm.init_caches(cfg, args.batch, args.new_tokens + 1,
                                device=dev)
        tok = torch.randint(0, cfg.vocab_size, (args.batch, 1),
                            generator=gen, device=dev, dtype=torch.int32)
        for i in range(args.new_tokens):
            tok, _, caches = decode(params, tok, caches, positions[i],
                                    encoder_states=enc)
        tok.cpu()                          # waits for the round's work
        total_tok += args.batch * args.new_tokens
        print(f"round {r}: {args.batch} seqs x {args.new_tokens} tokens")
    dt = time.time() - t0
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    print(f"served {total_tok} tokens in {dt:.1f}s "
          f"({total_tok/dt:.0f} tok/s, {args.arch} reduced, {where})")
    captures = len(decode.executables)
    print(f"decode step: {captures} CUDA graph capture(s) over "
          f"{args.rounds} rounds" if dev.type == "cuda"
          else "decode step: eager (no capture on the CPU)")
    return dict(tokens=total_tok, seconds=dt, captures=captures)


if __name__ == "__main__":
    main()
