#!/usr/bin/env python3
"""Time the crossbar GEMM call by call on the port's main paths, on one GPU.

Run from the repository root::

    python3 gemm_times.py [--src DIR] [--label NAME] [--out FILE]

It imports ``repro_torch`` from ``DIR`` (default: ``src/`` beside this
script), so the same script times another checkout's kernels, e.g. a
parent commit unpacked with ``git archive``, on the same card in the same
call.  For each path it serves one request through ``api.compile(...)
.run`` with ``crossbar_gemm`` recorded at the executor, then replays
every recorded call with its own operands (the main path's form: on
trees that mount a kernel-layout weight, the laid-out activations and
``wt``) and reports per call and summed per forward:

* the kernel's device time (``chip_smoke.device_ms``: 25 calls in one
  CUDA graph, median of 5 replays), and that it equals the plain version;
* the bound (``chip_smoke.gemm_bound``: operand bytes once, or 2*M*N*K
  int8 operations, x64 on the sliced branch, whichever is larger);
* the plain version's time, and for 2-D exact calls ``torch._int_mm``
  with the weight row-major (K, N) and K-major (``wt.t()`` of an (N, K)
  tensor: the layout cuBLASLt's int8 kernels take).

Paths: ResNet-18 at batches 16 and 1 (default ``HurryConfig``), AlexNet
under ``HurryConfig(adc_bits=8)`` at batch 4 (sliced branch), vit_tiny
at batch 16 (static and batched dynamic stages).  Then the exact static
stages of the benchmark's b1024 cells (``chip_smoke.CELL_SHAPES``:
vit_s16's patch, qkv, projection, fc1 and fc2, a conv of each of
resnet18's four stages) on seeded operands, each beside its bound and
``torch._int_mm`` with the weight K-major.  The card's name and power
limit come first; the last line of standard output is a JSON summary,
and ``--out`` keeps every call's numbers.  Without a CUDA device it
exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

import chip_smoke

PATHS = (("resnet18", {}, 16), ("resnet18", {}, 1),
         ("alexnet", {"adc_bits": 8}, 4), ("vit_tiny", {}, 16))


def record_calls(api, execute, net: str, cfg_kw: dict,
                 batch: int) -> list[tuple]:
    """The ``crossbar_gemm`` calls of one request of ``batch`` through
    the executor: (args, kwargs) each, with their operands."""
    import numpy as np
    import torch
    model = api.compile(net, api.HurryConfig(**cfg_kw), seed=0,
                        device="cuda")
    x = np.random.default_rng(0).standard_normal(
        model.graph.input_shape(batch)).astype(np.float32)
    calls = []
    real = execute.crossbar_gemm

    def record(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    execute.crossbar_gemm = record
    try:        # eagerly: model.run would capture, calling each GEMM twice
        execute.execute_packed(model.packed, torch.from_numpy(x).cuda())
    finally:
        execute.crossbar_gemm = real
    torch.cuda.synchronize()
    return calls


def call_shape(cg_mod, args, kw) -> tuple:
    """(xq, w, K, N, rows, exact, plain) of a recorded call: ``plain``
    computes the plain version on the same operands, the logical ones
    where x came in the kernel layout (zero padding: the same result)."""
    # (x, w) or, where the executor passes wt and K alone, (x,)
    xq, w = args[0], args[1] if len(args) > 1 else None
    wt = kw.get("wt")
    adc, rows = kw["adc_bits"], kw["rows"]
    K, N = (w.shape[-2:] if w is not None else (kw["K"], wt.shape[-2]))
    r = max(1, min(rows, K))
    exact = not cg_mod.clip_possible(r, adc)
    if w is None or xq.shape[-1] != K:
        xp, wp = xq, wt.mT
        rows_p = -(-r // 32) * 32
    else:
        xp, wp, rows_p = xq, w, r
    if exact:
        def plain():
            return cg_mod.crossbar_gemm_exact_ref(xp, wp)
    else:
        def plain():
            return cg_mod.crossbar_gemm_ref(xp, wp, adc_bits=adc,
                                            rows=rows_p)
    return xq, w, K, N, r, exact, plain


def time_path(api, execute, cg_mod, net: str, cfg_kw: dict,
              batch: int) -> list[dict]:
    import torch
    real = execute.crossbar_gemm
    rows_out = []
    for i, (args, kw) in enumerate(record_calls(api, execute, net, cfg_kw,
                                                batch)):
        xq, w, K, N, r, exact, plain = call_shape(cg_mod, args, kw)
        wt = kw.get("wt")
        got = real(xq, w, **kw)
        equal = bool(torch.equal(got, plain()))
        ms = chip_smoke.device_ms(lambda: real(xq, w, **kw))
        plain_ms = chip_smoke.device_ms(plain, calls=5)
        S = xq.shape[0] if xq.dim() == 3 else 1
        M = xq.shape[-2]
        b_ms, o_ms = chip_smoke.gemm_bound(M, N, K, sliced=not exact)
        row = dict(call=i, branch="exact" if exact else "sliced", S=S, M=M,
                   K=K, N=N, rows=r, ms=ms, plain_ms=plain_ms,
                   bound_ms=S * max(b_ms, o_ms),
                   bound_by="bytes" if b_ms >= o_ms else "operations",
                   equal=equal, int_mm_rowmajor_ms=None,
                   int_mm_kmajor_ms=None)
        if exact and S == 1:             # logical x: the first K columns
            row["int_mm_rowmajor_ms"], row["int_mm_kmajor_ms"] = \
                chip_smoke.int_mm_ms(xq[:, :K], w if w is not None
                                     else wt.mT[:K])
        rows_out.append(row)
        chip_smoke.detail(
            f"{net} b{batch} call {i}: {row['branch']} S={S} M={M} K={K} "
            f"N={N} rows={r}: {ms:.4f} ms (bound {row['bound_ms']:.5f} by "
            f"{row['bound_by']}, plain {plain_ms:.4f}, _int_mm row-major "
            f"{row['int_mm_rowmajor_ms']}, K-major "
            f"{row['int_mm_kmajor_ms']}), equal {equal}")
    return rows_out


def time_cells(cg_mod) -> list[dict]:
    """``chip_smoke.CELL_SHAPES`` on seeded operands in the main path's
    form (``chip_smoke.cell_operands``): the kernel's time, equal to the
    plain version or not, the bound and ``torch._int_mm`` with the weight
    K-major (the faster layout; the port never calls it)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for stage, M, K, N in chip_smoke.CELL_SHAPES:
        x, w, xk, wt = chip_smoke.cell_operands(gen, M, K, N)

        def run():
            return cg_mod.crossbar_gemm(xk, rows=511, wt=wt, K=K)
        equal = bool(torch.equal(run(), cg_mod.crossbar_gemm_exact_ref(x,
                                                                       w)))
        ms = chip_smoke.device_ms(run)
        b_ms, o_ms = chip_smoke.gemm_bound(M, N, K, sliced=False)
        _, int_mm = chip_smoke.int_mm_ms(x, w)
        row = dict(stage=stage, M=M, K=K, N=N, ms=ms,
                   bound_ms=max(b_ms, o_ms), int_mm_kmajor_ms=int_mm,
                   equal=equal)
        rows.append(row)
        chip_smoke.detail(
            f"{stage}: M={M} K={K} N={N}: {ms:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ({100 * row['bound_ms'] / ms:.1f}%), "
            f"_int_mm K-major {int_mm:.4f}, equal {equal}")
        del x, w, xk, wt
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = os.path.dirname(os.path.abspath(__file__))
    ap.add_argument("--src", default=os.path.join(here, "src"))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("gemm_times: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    for name in [m for m in sys.modules if m.startswith("repro_torch")]:
        del sys.modules[name]
    from repro_torch import api
    execute = importlib.import_module("repro_torch.program.execute")
    cg_mod = importlib.import_module("repro_torch.kernels.crossbar_gemm")
    print(chip_smoke.nvidia_smi(), flush=True)
    summary, everything = {}, {}
    for net, cfg_kw, batch in PATHS:
        key = f"{net}{'-adc8' if cfg_kw else ''}-b{batch}"
        rows = time_path(api, execute, cg_mod, net, cfg_kw, batch)
        everything[key] = rows
        lib = [min(r["int_mm_rowmajor_ms"], r["int_mm_kmajor_ms"])
               for r in rows if r["int_mm_rowmajor_ms"] is not None]
        summary[key] = dict(
            calls=len(rows), ms=sum(r["ms"] for r in rows),
            plain_ms=sum(r["plain_ms"] for r in rows),
            bound_ms=sum(r["bound_ms"] for r in rows),
            int_mm_rowmajor_ms=sum(r["int_mm_rowmajor_ms"] or 0.0
                                   for r in rows),
            int_mm_kmajor_ms=sum(r["int_mm_kmajor_ms"] or 0.0 for r in rows),
            int_mm_best_ms=sum(lib), all_equal=all(r["equal"] for r in rows))
        s = summary[key]
        print(f"[{args.label}] {key}: crossbar_gemm {s['ms']:.4f} ms in "
              f"{s['calls']} calls (bound {s['bound_ms']:.5f}, plain "
              f"{s['plain_ms']:.4f}, _int_mm row-major "
              f"{s['int_mm_rowmajor_ms']:.4f} / K-major "
              f"{s['int_mm_kmajor_ms']:.4f} / best {s['int_mm_best_ms']:.4f} "
              f"over the 2-D exact calls), all equal {s['all_equal']}",
              flush=True)
    cells = time_cells(cg_mod)
    for r in cells:
        print(f"[{args.label}] {r['stage']} b1024: crossbar_gemm "
              f"{r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, "
              f"{100 * r['bound_ms'] / r['ms']:.1f}%; _int_mm K-major "
              f"{r['int_mm_kmajor_ms']:.4f}), equal {r['equal']}",
              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"label": args.label, "card": chip_smoke.nvidia_smi(),
                       "calls": everything, "cells_b1024": cells}, f,
                      indent=1)
    print(json.dumps({"label": args.label, "summary": summary,
                      "cells_b1024": cells}))
    equal = all(s["all_equal"] for s in summary.values()) and all(
        r["equal"] for r in cells)
    return 0 if equal else 2


if __name__ == "__main__":
    sys.exit(main())
