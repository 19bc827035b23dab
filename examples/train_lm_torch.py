"""End-to-end training driver: ~100M-param LM for a few hundred steps.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 200 \\
        [--device cpu]

The PyTorch port's counterpart of ``examples/train_lm.py``.  Exercises the
full substrate on one device: config -> model -> data pipeline -> train
step -> checkpoint/restart (kill it mid-run and rerun: it resumes from
the last committed step and regenerates exactly the batches it needs).
Checkpoints are the JAX package's format, so ``--ckpt-dir`` defaults to
a directory of its own under the temporary directory (``TMPDIR``): a
shared one would resume the other package's run.  Each step is saved at
most once.  The step is compiled as the JAX example jits it
(``repro_torch.train.step.compile_train_step``: on the GPU one CUDA
graph, captured at the second step of the run, the first running
eagerly; on the CPU the eager step).  The LM stack is plain PyTorch and launches none of the port's
CUDA kernels.  ``main(argv)`` returns the numbers it prints;
``train`` is the loop itself.
"""

import argparse
import dataclasses
import os
import statistics
import tempfile
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.train.checkpoint import (latest_step, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.step import compile_train_step
from repro_torch.tree import tree_leaves


def build_100m_config():
    """~100M params: internlm2 family scaled down."""
    return dataclasses.replace(
        get_config("internlm2_1_8b"), n_layers=8, d_model=512, n_heads=8,
        n_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32000)


def train(cfg, params: dict, *, steps: int, batch: int, seq: int,
          ckpt_dir: str, ckpt_every: int) -> dict:
    """Train ``params`` (on their device) to ``steps``, resuming from the
    newest checkpoint in ``ckpt_dir`` if there is one.

    Returns the final parameters and optimizer state, the step it
    started from, each step's loss, the median step time (host clock
    around each step, ending in a device synchronize) and the number of
    CUDA graph captures.  On the GPU the parameters and optimizer state
    returned are the compiled step's own buffers, which its next replay
    would overwrite; none follows the loop.
    """
    dev = tree_leaves(params)[0].device
    opt = init_opt_state(params)
    pipe = TokenPipeline(cfg.vocab_size, batch, seq, seed=17, device=dev)

    start = latest_step(ckpt_dir)
    if start is not None:
        params, opt, ds = restore_checkpoint(ckpt_dir, start, params, opt)
        pipe = TokenPipeline.from_state(cfg.vocab_size, batch, seq, ds,
                                        device=dev)
        print(f"resumed from step {start}")
    start = start or 0

    step_fn = compile_train_step(cfg, OptimizerConfig(lr=1e-3),
                                 remat=False)
    losses, durations = [], []
    for i in range(start, steps):
        t0 = time.perf_counter()
        b = pipe.batch_at(i)
        pipe.step = i + 1
        params, opt, metrics = step_fn(params, opt, b)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        durations.append(time.perf_counter() - t0)
        losses.append(metrics["loss"])    # a fresh tensor every step
        if (i + 1) % 10 == 0:
            print(f"step {i+1:4d}  loss {float(metrics['loss']):.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"{durations[-1]*1e3:.0f} ms/step")
        if (i + 1) % ckpt_every == 0 or i + 1 == steps:
            save_checkpoint(ckpt_dir, i + 1, params, opt, pipe.state())
    captures = len(step_fn.executables)
    if dev.type == "cuda":
        print(f"train step: {captures} CUDA graph capture(s) over "
              f"{steps - start} steps")
    return dict(params=params, opt=opt, start=start,
                losses=[float(v) for v in losses],
                step_s=statistics.median(durations) if durations else None,
                captures=captures)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    print("device:", torch.cuda.get_device_name(dev) if dev.type == "cuda"
          else dev)
    cfg = build_100m_config()
    n_params_est = (cfg.n_layers
                    * (cfg.d_model * cfg.resolved_head_dim
                       * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
                       + 3 * cfg.d_model * cfg.d_ff)
                    + 2 * cfg.padded_vocab * cfg.d_model)
    print(f"model: {cfg.name}-100m  (~{n_params_est/1e6:.0f}M params)")

    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0),
                            device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    r = train(cfg, params, steps=args.steps, batch=args.batch,
              seq=args.seq, ckpt_dir=args.ckpt_dir,
              ckpt_every=args.ckpt_every)
    out = dict(r, device=str(dev), steps=args.steps)
    if r["step_s"] is not None:
        out.update(ms_per_step=r["step_s"] * 1e3,
                   tok_s=args.batch * args.seq / r["step_s"])
        peak = ""
        if dev.type == "cuda":
            out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
            peak = f", peak {out['peak_gb']:.2f} GB"
        print(f"median {out['ms_per_step']:.1f} ms/step, "
              f"{out['tok_s']:.0f} tokens/s{peak}")
    print("done.")
    return out


if __name__ == "__main__":
    main()
