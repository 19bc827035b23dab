#!/usr/bin/env python3
"""Profile the full-size InternLM2-1.8B train step with the stacked
per-layer weights taken apart in two ways, on one GPU.

Run from the repository root::

    python3 train_profile.py [--steps N] [--out FILE]

``models.lm`` takes each stacked leaf apart with one ``unbind`` per
forward, whose backward pass stacks the layers' gradients once
(``unbind``).  Before it, the layer loops indexed layer ``i`` of every
leaf (``t[i]``), whose backward pass writes a zero tensor of the whole
stack and adds into it for every layer (``select``, restored here by
patching ``lm._unstack``).  Both run the same train step
(``make_train_step(cfg, OptimizerConfig(lr=1e-3), remat=True)``, b1 x
4096 from ``TokenPipeline(seed=11)``) on the same parameters, in the
order select, unbind, unbind, select.  For each: the step's time (host
clock around the step and a synchronize, median of ``--steps`` after a
warm-up), its peak device memory, and one step's profile (device busy
time, fill/memset launches and time, GEMM time, the rest).  The card's
name and power limit come first; the last line of standard output is a
JSON record.  Without a CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import chip_smoke


def _select_unstack(tree) -> list:
    """The per-layer trees as ``t[i]`` views of every stacked leaf."""
    from repro_torch.tree import tree_leaves, tree_map
    n = tree_leaves(tree)[0].shape[0]
    return [tree_map(lambda t: t[i], tree) for i in range(n)]


def run(mode: str, unstack, step, params, opt, batch, steps: int) -> dict:
    import torch
    from repro_torch.models import lm
    lm._unstack = unstack
    step(params, opt, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step(params, opt, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 1e9
    busy, kernels = chip_smoke.forward_profile(
        lambda: step(params, opt, batch), runs=1, top=None, name_chars=400)
    rec = dict(mode=mode, step_ms=statistics.median(times), times=times,
               peak_gb=peak, busy_ms=busy)
    if busy is not None:
        fills = [(ms, n) for ms, n, name in kernels
                 if chip_smoke._is_fill(name)]
        rec.update(
            launches=sum(n for _, n, _ in kernels),
            fill_launches=sum(n for _, n in fills),
            fill_ms=sum(ms for ms, _ in fills),
            gemm_ms=sum(ms for ms, _, name in kernels
                        if chip_smoke._is_gemm(name)),
            top=[(round(ms, 3), n, name[:100]) for ms, n, name in
                 kernels[:8]])
        rec["other_ms"] = busy - rec["fill_ms"] - rec["gemm_ms"]
    return rec


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--out", help="also write the JSON record here")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("train_profile: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import lm
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train.step import make_train_step
    ways = {"select": _select_unstack, "unbind": lm._unstack}
    card = chip_smoke.nvidia_smi()
    print(card, flush=True)
    dev = torch.device("cuda")
    cfg = get_config("internlm2_1_8b")
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0),
                            device=dev)
    opt = init_opt_state(params)
    batch = TokenPipeline(cfg.vocab_size, 1, 4096, seed=11,
                          device=dev).batch_at(0)
    step = make_train_step(cfg, OptimizerConfig(lr=1e-3), remat=True)
    recs = []
    for mode in ("select", "unbind", "unbind", "select"):
        rec = run(mode, ways[mode], step, params, opt, batch, args.steps)
        recs.append(rec)
        prof = ("no profiler device events" if rec["busy_ms"] is None else
                f"busy {rec['busy_ms']:.1f} ms in {rec['launches']} "
                f"launches: fill/memset {rec['fill_ms']:.1f} ms in "
                f"{rec['fill_launches']}, GEMMs {rec['gemm_ms']:.1f} ms, "
                f"the rest {rec['other_ms']:.1f} ms")
        print(f"[{mode}] step {rec['step_ms']:.1f} ms (median of "
              f"{args.steps}), peak {rec['peak_gb']:.1f} GB; {prof} | "
              f"{card}", flush=True)
        for ms, n, name in rec.get("top", []):
            print(f"  {mode}: {name}: {ms} ms in {n} launches",
                  file=sys.stderr)
    out = dict(card=card, device=torch.cuda.get_device_name(0),
               runs=recs)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
