#!/usr/bin/env python3
"""Time variants of the crossbar GEMM kernel against each other, on one GPU.

Run from the repository root::

    python3 gemm_variants.py [--out FILE]

Each variant is ``csrc/crossbar_gemm.cu`` with a few lines replaced (the
``VARIANTS`` table: a deeper ring, other K splits, scalar stores, and, for
the time breakdowns, a mainloop without its copies after the first
ring's worth, without its tensor-core products, or without its bit
expansion).  All variants build in parallel with the
flags of ``kernels/_build.py`` into ``build/variants/`` and run, in turns,
on the same operands:

* ResNet-18's stages at batches 16 and 1 and AlexNet's at batch 4 under
  ``HurryConfig(adc_bits=8)``, in the main path's form (x in the kernel
  layout, the packed ``wt``), summed per forward, each call held against
  the plain version where the variant computes the full product;
* long-K probes (``PROBES``), one block and many, unsplit: the time per
  128-byte k-slab of a block's mainloop, on each branch.

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

# name -> (replacements, timing_only)
VARIANTS = {
    "as committed": ([], False),
    "exact ring of 6": ([("constexpr int EX_STAGES = 4;",
                          "constexpr int EX_STAGES = 6;")], False),
    "exact without K split": ([(
        "  if (4 * tiles > SM_COUNT || nk < EX_SPLIT_FROM) return 1;",
        "  return 1;")], False),
    "exact split below all the SMs": ([(
        "  if (4 * tiles > SM_COUNT || nk < EX_SPLIT_FROM) return 1;",
        "  if (tiles >= SM_COUNT || nk < EX_SPLIT_FROM) return 1;")], False),
    "exact split below half the SMs": ([(
        "  if (4 * tiles > SM_COUNT || nk < EX_SPLIT_FROM) return 1;",
        "  if (2 * tiles > SM_COUNT || nk < EX_SPLIT_FROM) return 1;")],
        False),
    "exact scalar stores": ([("    } else if ((N & 1) == 0) {",
                              "    } else if (false) {")], False),
    "exact mainloop without copies": ([
        (_EX_WAIT, "    if (t < EX_STAGES)\n  " + _EX_WAIT),
        (_EX_REFILL, _EX_REFILL.replace("tid == 0", "false"))], True),
    "exact mainloop without wgmma": ([(_EX_MMA, "")], True),
    "sliced without chunk split": ([(
        "  const int splits = (int)((2 * SM_COUNT + tiles - 1) / tiles);",
        "  const int splits = 1;")], False),
    "sliced 2 slabs ahead": ([("constexpr int SL_AHEAD = 4;",
                               "constexpr int SL_AHEAD = 2;")], False),
    "sliced without expansion": ([(_SL_EXPAND, (
        "    if (t + 1 < nslab)\n"
        "      mbar_wait(bar0 + 8 * ((t + 1) % SL_RAW), ((t + 1) / SL_RAW) & 1);"
    ))], True),
    "sliced without wgmma": ([(_SL_MMA, "")], True),
}
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
    from repro_torch.kernels import (_build, clip_possible,
                                     crossbar_gemm_exact_ref,
                                     crossbar_gemm_ref, kernel_layout,
                                     mount_weight)
    module = importlib.import_module("repro_torch.kernels.crossbar_gemm")
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(
            lambda n: build_variant(n, _build), VARIANTS)))
    print(chip_smoke.nvidia_smi(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def calls_of(net: str, cfg_kw: dict, batch: int) -> list[tuple]:
        """(x, xk, w8, wt, rows, adc, exact) per stage, main path form."""
        model = api.compile(net, api.HurryConfig(**cfg_kw), seed=0,
                            device="cuda")
        adc = model.config.adc_bits
        out = []
        for s in chip_smoke.stage_shapes(model, batch):
            x = torch.randint(-128, 128, (s["M"], s["K"]), generator=gen,
                              device=dev, dtype=torch.int8)
            rows = min(s["rows"], s["K"])
            xk = kernel_layout(x, s["K"], rows=rows, adc_bits=adc)
            out.append((x, xk.contiguous(), s["w8"], s["wt"], rows, adc,
                        not clip_possible(rows, adc)))
        return out

    paths = {"resnet18-b16": calls_of("resnet18", {}, 16),
             "resnet18-b1": calls_of("resnet18", {}, 1),
             "alexnet-adc8-b4": calls_of("alexnet", {"adc_bits": 8}, 4)}
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
    summary = {}
    for name, path in libs.items():
        lib = module.declare(ctypes.CDLL(path))
        module._lib = lambda lib=lib: lib
        timing_only = VARIANTS[name][1]
        row = {}
        for key, calls in paths.items():
            total = 0.0
            for x, xk, w, wt, rows, adc, exact in calls:
                N = w.shape[1]

                def run():
                    return module._launch(xk, wt, N, exact=exact, rows=rows,
                                          adc_bits=adc)
                if not timing_only:
                    ref = crossbar_gemm_exact_ref(x, w) if exact else \
                        crossbar_gemm_ref(x, w, adc_bits=adc, rows=rows)
                    chip_smoke.check(torch.equal(run(), ref),
                                     f"variant {name!r} differs on {key}")
                total += chip_smoke.device_ms(run)
            row[key] = total
        for branch, M, K, N, rows, x, w, wt, xk, kw in probes:
            nslab = xk.shape[1] // 128

            def run():
                return module._launch(xk, wt, N, exact=kw["exact"],
                                      rows=rows, adc_bits=kw["adc_bits"],
                                      split=1)
            ms = chip_smoke.device_ms(run)
            row[f"{branch} {M}x{K}x{N}"] = ms
            row[f"{branch} {M}x{K}x{N} us per slab"] = ms * 1e3 / nslab
        summary[name] = row
        print(f"{name}{' (timing only)' if timing_only else ''}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in row.items()), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": chip_smoke.nvidia_smi(), "variants": summary},
                      f, indent=1)
    print(json.dumps({"variants": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
