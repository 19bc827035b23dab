"""Batched serving example: prefill + continuous greedy decode.

    PYTHONPATH=src python examples/serve_lm_torch.py [--arch xlstm_1_3b] \\
        [--device cpu]

The PyTorch port's counterpart of ``examples/serve_lm.py``.  Loads a
reduced config of the chosen architecture (``inputs``: drawn on the
CPU, so that every device serves the same numbers), runs
the prompts through prefill token by token, then decodes greedily with
the per-family O(1) state / KV-cache step, compiled as the JAX example
jits it (``serve.step.compile_decode_step``: one CUDA graph per key on
the GPU, replayed for every token; bfloat16 compute as in the JAX
package).  The LM stack is plain PyTorch
and launches none of the port's CUDA kernels.  ``main(argv)`` returns
the numbers it prints; ``generate`` is the loop itself.
"""

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serve.step import compile_decode_step
from repro_torch.tree import tree_map


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(cfg, params, prompts: torch.Tensor, enc, new_tokens: int, *,
             compute_dtype=torch.bfloat16) -> dict:
    """Prefill ``prompts`` (B, P) token by token, then decode
    ``new_tokens`` greedily, on the device of ``params``.

    Returns the sequences (B, P + new_tokens), every step's last-position
    logits (B, P + new_tokens - 1, V) as float32, and the prefill and
    decode seconds (host clock around work that ends in a device
    synchronize).
    """
    dev = prompts.device
    B, P = prompts.shape
    max_len = P + new_tokens
    caches = lm.init_caches(cfg, B, max_len, dtype=compute_dtype,
                            params=params)
    decode = compile_decode_step(cfg, compute_dtype)
    if enc is not None:
        enc = enc.to(compute_dtype)
    positions = torch.arange(max_len, dtype=torch.int32, device=dev)
    logits = []

    # prefill token-by-token (state-correct for every family)
    tok = prompts[:, :1]
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(P - 1):
        _, lg, caches = decode(params, tok, caches, positions[i],
                               encoder_states=enc)
        logits.append(lg[:, -1])
        tok = prompts[:, i + 1:i + 2]
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    out = [prompts]
    t0 = time.perf_counter()
    for i in range(P - 1, max_len - 1):
        tok, lg, caches = decode(params, tok, caches, positions[i],
                                 encoder_states=enc)
        logits.append(lg[:, -1])
        out.append(tok)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    return dict(seqs=torch.cat(out, 1),
                logits=torch.stack(logits, 1).float(),
                prefill_s=prefill_s, decode_s=decode_s)


def inputs(arch: str, batch: int, prompt_len: int, device) -> tuple:
    """(cfg, params, prompts, encoder states or None): the reduced
    config, weights from a generator seeded 0, prompts seeded 1,
    Whisper's bfloat16 encoder states seeded 2, drawn on the CPU and
    moved to ``device``."""
    cfg = get_config(arch).reduced()
    params = tree_map(lambda t: t.to(device), lm.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=torch.Generator().manual_seed(1),
                            dtype=torch.int32).to(device)
    enc = None
    if cfg.is_encdec:
        enc = torch.randn((batch, cfg.encoder_seq, cfg.d_model),
                          generator=torch.Generator().manual_seed(2)
                          ).to(torch.bfloat16).to(device)
    return cfg, params, prompts, enc


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2_1_8b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    print("device:", torch.cuda.get_device_name(dev) if dev.type == "cuda"
          else dev)
    B = args.batch
    cfg, params, prompts, enc = inputs(args.arch, B, args.prompt_len, dev)
    r = generate(cfg, params, prompts, enc, args.new_tokens)
    tok_s = args.new_tokens * B / max(r["decode_s"], 1e-9)
    ids = r["seqs"][0, args.prompt_len:args.prompt_len + 12].tolist()
    print(f"arch={cfg.name} (reduced)  batch={B}")
    print(f"prefill: {args.prompt_len} tok in {r['prefill_s']*1e3:.0f} ms | "
          f"decode: {args.new_tokens} tok in {r['decode_s']*1e3:.0f} ms "
          f"({tok_s:.0f} tok/s batch)")
    print("sample continuation ids:", ids)
    return dict(r, arch=args.arch, device=str(dev), batch=B,
                prompt_len=args.prompt_len,
                prefill_ms=r["prefill_s"] * 1e3,
                decode_ms=r["decode_s"] * 1e3, tok_s=tok_s, ids=ids)


if __name__ == "__main__":
    main()
