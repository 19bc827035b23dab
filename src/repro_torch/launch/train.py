"""Production training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2_1_8b \\
        [--reduced] [--steps N] [--ckpt-dir DIR] [--device cpu]

The port of ``repro.launch.train``, with the same flags plus ``--device``
(default: the GPU).  Fault-tolerance contract:

  * resume: on start, the newest committed checkpoint is restored and the
    data pipeline skips ahead deterministically;
  * preemption: SIGTERM sets a flag; the loop checkpoints and exits
    cleanly at the next step boundary (re-launch resumes);
  * elastic rescale: checkpoints are mesh-shape independent
    (``train/checkpoint.py``);
  * straggler mitigation at this layer is the synchronous kind:
    per-step wall-clock is logged and steps exceeding
    ``--straggler-factor`` x the trailing median are flagged so the
    cluster scheduler can evict slow hosts.

The step is compiled as the JAX launcher jits it
(``repro_torch.train.step.compile_train_step``: on the GPU one CUDA graph
per key, captured at the second step of each process, the first running
eagerly; on the CPU the eager step), and the number of captures is printed at the end.  The
full-size model trains with ``remat`` on, as in the JAX launcher;
``--reduced`` turns it off.  ``--ckpt-dir`` defaults to a directory
under the temporary directory (``TMPDIR``).
"""

from __future__ import annotations

import argparse
import os
import signal
import statistics
import tempfile
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.train.checkpoint import (latest_step, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.step import compile_train_step

_PREEMPTED = False


def _on_sigterm(signum, frame):
    global _PREEMPTED
    _PREEMPTED = True


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2_1_8b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    previous = signal.signal(signal.SIGTERM, _on_sigterm)
    try:
        return _train(args, dev)
    finally:
        signal.signal(signal.SIGTERM, previous)


def _train(args, dev: torch.device) -> dict:
    """The loop; returns the number of steps run and of captures."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0),
                            device=dev)
    opt = init_opt_state(params)
    pipe = TokenPipeline(cfg.vocab_size, args.batch, args.seq, seed=11,
                         device=dev)

    start = latest_step(args.ckpt_dir)
    if start is not None:
        params, opt, ds = restore_checkpoint(args.ckpt_dir, start, params,
                                             opt)
        pipe = TokenPipeline.from_state(cfg.vocab_size, args.batch,
                                        args.seq, ds, device=dev)
        print(f"[resume] step {start}")
    start = start or 0

    step_fn = compile_train_step(
        cfg, OptimizerConfig(lr=args.lr), remat=not args.reduced,
        microbatches=args.microbatches)

    durations: list[float] = []
    saved = start
    for i in range(start, args.steps):
        t0 = time.time()
        batch = pipe.batch_at(i)
        pipe.step = i + 1
        params, opt, metrics = step_fn(params, opt, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.time() - t0
        durations.append(dt)
        med = statistics.median(durations[-20:])
        if dt > args.straggler_factor * med and len(durations) > 5:
            print(f"[straggler] step {i} took {dt:.2f}s "
                  f"(median {med:.2f}s) — flagging for eviction")
        if (i + 1) % 10 == 0:
            print(f"step {i+1:5d}  loss {float(metrics['loss']):.4f}  "
                  f"{dt*1e3:.0f} ms")
        if (i + 1) % args.ckpt_every == 0 or _PREEMPTED:
            save_checkpoint(args.ckpt_dir, i + 1, params, opt, pipe.state())
            saved = i + 1
            if _PREEMPTED:
                print(f"[preempt] checkpointed at {i+1}, exiting cleanly")
                return _captures(step_fn, dev, i + 1 - start)
    # the JAX launcher saves the last step a second time when
    # --ckpt-every divides --steps, and its rename onto the existing
    # step_N then fails; the port saves each step once
    if saved != args.steps:
        save_checkpoint(args.ckpt_dir, args.steps, params, opt,
                        pipe.state())
    print("training complete")
    return _captures(step_fn, dev, args.steps - start)


def _captures(step_fn, dev: torch.device, steps: int) -> dict:
    captures = len(step_fn.executables)
    print(f"train step: {captures} CUDA graph capture(s) over {steps} "
          "steps" if dev.type == "cuda"
          else "train step: eager (no capture on the CPU)")
    return dict(steps=steps, captures=captures)


if __name__ == "__main__":
    main()
