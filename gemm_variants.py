#!/usr/bin/env python3
"""Time variants of the crossbar GEMM kernel against each other, on one GPU.

Run from the repository root::

    python3 gemm_variants.py [--out FILE]

Each variant is ``csrc/crossbar_gemm.cu`` with a few lines replaced (the
``VARIANTS`` table: the 64 x 64 tiles in either order, a deeper ring, no
K split, scalar stores, narrower wide tiles, the wide tiles on every 2-D
call that K does not split, and, for the time breakdowns, the wide tiles without their stores or their
products, the 64 x 64 mainloop without its copies after the first
ring's worth or without its tensor-core products, the sliced one without
its bit expansion).  All variants build in parallel with the flags of
``kernels/_build.py`` into ``build/variants/`` and run, in turns, on the
same operands:

* ``PATHS``: every ``crossbar_gemm`` call of one request through the
  executor (``gemm_times.record_calls``: ResNet-18 at batches 16 and 1,
  AlexNet at batch 4 under ``HurryConfig(adc_bits=8)``, vit_tiny and
  vit_s16 at batch 16), summed per forward, each call held against the
  plain version where the variant computes the full product, and timed
  alone on standard error where the variant's plan differs from the
  committed one;
* long-K probes (``PROBES``), one block and many, unsplit: the time per
  128-byte k-slab of a block's mainloop, on each branch;
* the b1024 cells' exact static stages (``chip_smoke.CELL_SHAPES``: x of
  77-604 MB, N 64-1536) and 2-D shapes on either side of the plan's rule
  (``RULE_SHAPES``), each beside its bound and its plan.

A variant is the source with lines replaced, the exact plan's rule
replaced (``tile64_plan``: the 64 x 64 tiles everywhere), or both.

Times are ``chip_smoke.device_ms`` (25 calls in a CUDA graph, median of
5 replays).  A variant marked ``timing_only`` computes a wrong result by
design and is only timed.  The card's name and power limit come first;
the last line of standard output is a JSON summary.  Without a CUDA
device it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import chip_smoke
import gemm_times

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                      "crossbar_gemm.cu")

_EX_MMA = """      wgmma_n64(acc, sw128_desc(a_st + 32 * kk), sw128_desc(b_st + 32 * kk),
                1);"""
_EX_WAIT = "    mbar_wait(bar0 + 8 * st, (t / EX_STAGES) & 1);"
_EX_REFILL = "    if (tid == 0 && t + EX_STAGES < T) issue(t + EX_STAGES);"
_SL_EXPAND = "    if (t + 1 < nslab) expand(t + 1);     // the next slab's planes"
_SL_MMA = """        wgmma_n256(cnt, sw128_desc(a_st + 32 * kk),
                   sw128_desc(b_st + 32 * kk), pos == 0 ? 0 : 1);"""

_WD_STORE = ("    store_tile<BN>(acc, y, m0 + (WD_BM / 2) * wg + 16 * (warp & 3), "
             "n0, M, N,")
_WD_MMA = """        wgmma_s8<BN>(acc, sw128_desc(a_st + 32 * kk),
                     sw128_desc(b_st + 32 * kk));"""
_GRID64 = """    const dim3 grid((M + EX_BM - 1) / EX_BM, (N + EX_BN - 1) / EX_BN,
                    S * splits);"""
_TILE64_AT = "  const int m0 = blockIdx.x * EX_BM, n0 = blockIdx.y * EX_BN;"


def _tile64(module):
    return module.tile64_plan


def _unsplit(module):
    plan = module.exact_plan
    return lambda *shape: plan(*shape)._replace(splits=1)


def _wide_unsplit(module):
    plan = module.exact_plan

    def rule(S, M, N, kk):
        p = plan(S, M, N, kk)
        return module.wide_plan(N) if S == 1 and p.splits == 1 else p
    return rule


def _at_most_128(module):
    plan = module.exact_plan

    def rule(S, M, N, kk):
        p = plan(S, M, N, kk)
        return p._replace(bn=min(p.bn, 128)) if p.bm == 128 else p
    return rule


# name -> (replacements, timing_only, the exact plan's rule or None for
# the committed ``exact_plan``: a function of the wrapper's module)
VARIANTS = {
    "as committed": ([], False, None),
    "64 x 64 tiles, M first": ([], False, _tile64),
    "64 x 64 tiles, N first": ([
        (_GRID64, _GRID64.replace(
            "(M + EX_BM - 1) / EX_BM, (N + EX_BN - 1) / EX_BN",
            "(N + EX_BN - 1) / EX_BN, (M + EX_BM - 1) / EX_BM")),
        (_TILE64_AT, _TILE64_AT.replace("blockIdx.x * EX_BM", "blockIdx.y * "
                                        "EX_BM").replace(
            "blockIdx.y * EX_BN", "blockIdx.x * EX_BN"))], False, _tile64),
    "exact ring of 6": ([("constexpr int EX_STAGES = 4;",
                          "constexpr int EX_STAGES = 6;")], False, None),
    "exact without K split": ([], False, _unsplit),
    "exact scalar stores": ([("    } else if ((N & 1) == 0) {",
                              "    } else if (false) {")], False, None),
    "wide tiles without stores": ([(_WD_STORE, "    if (acc[0] == 0x7fffffff)"
                                    "\n  " + _WD_STORE)], True, None),
    "wide tiles without wgmma": ([(_WD_MMA, "")], True, None),
    "wide tiles at most 128 wide": ([], False, _at_most_128),
    "wide tiles wherever K is not split": ([], False, _wide_unsplit),
    "exact mainloop without copies": ([
        (_EX_WAIT, "    if (t < EX_STAGES)\n  " + _EX_WAIT),
        (_EX_REFILL, _EX_REFILL.replace("tid == 0", "false"))], True,
        _tile64),
    "exact mainloop without wgmma": ([(_EX_MMA, "")], True, _tile64),
    "sliced without chunk split": ([(
        "  const int splits = (int)((2 * SM_COUNT + tiles - 1) / tiles);",
        "  const int splits = 1;")], False, None),
    "sliced 2 slabs ahead": ([("constexpr int SL_AHEAD = 4;",
                               "constexpr int SL_AHEAD = 2;")], False, None),
    "sliced without expansion": ([(_SL_EXPAND, (
        "    if (t + 1 < nslab)\n"
        "      mbar_wait(bar0 + 8 * ((t + 1) % SL_RAW), ((t + 1) / SL_RAW) & 1);"
    ))], True, None),
    "sliced without wgmma": ([(_SL_MMA, "")], True, None),
}
# the paths, each call as the executor makes it: gemm_times.PATHS and
# vit_s16 at batch 16
PATHS = gemm_times.PATHS + (("vit_s16", {}, 16),)
# 2-D shapes beside the b1024 cells' (chip_smoke.CELL_SHAPES) on either
# side of the plan's rule: (name, M, K, N).  vit_s16's b1024 head (32 wide
# tiles, short of the SMs), and 150 and 280 wide tiles, whose last round
# leaves most SMs idle.
RULE_SHAPES = (("vit_s16 head b1024", 1024, 384, 1000),
               ("150 tiles", 19200, 576, 64),
               ("280 tiles", 35840, 576, 64))
# long-K probes, one block and many: (branch, M, K, N, rows)
PROBES = [("exact", 64, 32768, 64, 511), ("exact", 16384, 1024, 64, 511),
          ("sliced", 2048, 8192, 256, 512), ("sliced", 8, 8192, 32, 512)]


def build_variant(name: str, build) -> str:
    src = open(SOURCE).read()
    for old, new in VARIANTS[name][0]:
        if old not in src:
            raise SystemExit(f"variant {name!r}: the source no longer holds "
                             f"{old[:60]!r}")
        src = src.replace(old, new)
    out_dir = os.path.join(ROOT, "build", "variants")
    os.makedirs(out_dir, exist_ok=True)
    stem = "".join(c if c.isalnum() else "_" for c in name)
    cu = os.path.join(out_dir, f"{stem}.cu")
    with open(cu, "w") as f:
        f.write(src)
    lib = os.path.join(out_dir, f"lib{stem}.so")
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib, cu],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed for {name!r}:\n{proc.stderr}")
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("gemm_variants: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    from repro_torch import api
    from repro_torch.kernels import (_build, crossbar_gemm_exact_ref,
                                     kernel_layout, mount_weight)
    execute = importlib.import_module("repro_torch.program.execute")
    module = importlib.import_module("repro_torch.kernels.crossbar_gemm")
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(
            lambda n: build_variant(n, _build), VARIANTS)))
    print(chip_smoke.nvidia_smi(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    paths = {}
    for net, cfg_kw, batch in PATHS:
        key = f"{net}{'-adc8' if cfg_kw else ''}-b{batch}"
        paths[key] = []
        for call, kw in gemm_times.record_calls(api, execute, net, cfg_kw,
                                                batch):
            xq, _, _, N, _, exact, plain = gemm_times.call_shape(
                module, call, kw)
            S = xq.shape[0] if xq.dim() == 3 else 1
            shape = (S, xq.shape[-2], N, xq.shape[-1]) if exact else None
            paths[key].append((call, kw, plain(), shape))
    probes = []
    for branch, M, K, N, rows in PROBES:
        x = torch.randint(-128, 128, (M, K), generator=gen, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-128, 128, (K, N), generator=gen, device=dev,
                          dtype=torch.int8)
        kw = dict(rows=rows, adc_bits=8 if branch == "sliced" else 9,
                  exact=branch == "exact")
        probes.append((branch, M, K, N, rows, x, w, mount_weight(w, **kw),
                       kernel_layout(x, K, **kw).contiguous(), kw))
    regimes = []
    for label, M, K, N in chip_smoke.CELL_SHAPES + RULE_SHAPES:
        x, w, xk, wt = chip_smoke.cell_operands(gen, M, K, N)
        b_ms, o_ms = chip_smoke.gemm_bound(M, N, K, sliced=False)
        regimes.append((label, M, K, N, wt, xk,
                        crossbar_gemm_exact_ref(x, w), max(b_ms, o_ms)))
        del x, w
    committed_plan = module.exact_plan
    summary = {}
    for name, path in libs.items():
        lib = module.declare(ctypes.CDLL(path))
        module._lib = lambda lib=lib: lib
        rule = VARIANTS[name][2]
        module.exact_plan = committed_plan
        if rule:
            module.exact_plan = rule(module)
        timing_only = VARIANTS[name][1]
        row = {}
        for key, calls in paths.items():
            total = 0.0
            for call, kw, ref, shape in calls:
                def run():
                    return module.crossbar_gemm(*call, **kw)
                if not timing_only:
                    chip_smoke.check(torch.equal(run(), ref),
                                     f"variant {name!r} differs on {key}")
                ms = chip_smoke.device_ms(run)
                total += ms
                if shape and module.exact_plan(*shape) != committed_plan(
                        *shape):
                    chip_smoke.detail(
                        f"{name}: {key} (S, M, N, Kk) {shape} plan "
                        f"{tuple(module.exact_plan(*shape))}: {ms:.4f} ms")
            row[key] = total
        for branch, M, K, N, rows, x, w, wt, xk, kw in probes:
            nslab = xk.shape[1] // 128

            force = (dict(plan=module.exact_plan(1, M, N, xk.shape[1])
                          ._replace(splits=1)) if kw["exact"]
                     else dict(split=1))

            def run():
                return module._launch(xk, wt, N, exact=kw["exact"],
                                      rows=rows, adc_bits=kw["adc_bits"],
                                      **force)
            ms = chip_smoke.device_ms(run)
            row[f"{branch} {M}x{K}x{N}"] = ms
            row[f"{branch} {M}x{K}x{N} us per slab"] = ms * 1e3 / nslab
        for label, M, K, N, wt, xk, ref, bound in regimes:
            def run():
                return module._launch(xk, wt, N, exact=True, rows=511,
                                      adc_bits=9)
            if not timing_only:
                chip_smoke.check(torch.equal(run(), ref),
                                 f"variant {name!r} differs on {label}")
            ms = chip_smoke.device_ms(run)
            plan = module.exact_plan(1, M, N, xk.shape[1])
            row[label] = ms
            row[f"{label} bound share"] = bound / ms
            chip_smoke.detail(f"{name}: {label} M={M} K={K} N={N} plan "
                              f"{tuple(plan)}: {ms:.4f} ms, bound "
                              f"{bound:.4f} ({100 * bound / ms:.1f}%)")
        summary[name] = row
        print(f"{name}{' (timing only)' if timing_only else ''}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in row.items()), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": chip_smoke.nvidia_smi(), "variants": summary},
                      f, indent=1)
    module.exact_plan = committed_plan
    print(json.dumps({"variants": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
