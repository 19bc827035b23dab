#!/usr/bin/env python3
"""Time variants of the float GEMM kernels against each other, on one GPU.

Run from the repository root::

    python3 float_gemm_variants.py [--out FILE]

Each variant is ``csrc/mma_gemm.cuh``, ``csrc/fused_gemm_epilogue.cu`` and
``csrc/packed_gemm.cu`` with a few lines replaced (the ``VARIANTS``
table: the TF32 split by ``cvt.rna``, other ring depths, 8 warps a
block, SiLU's division as ``__frcp_rn``, and, for the time breakdowns, a
mainloop without its copies or without its products, an epilogue without
its activation, a split's exchange without its remote reads or without
its first cluster barrier).  A variant marked ``probe`` also stamps the
``globaltimer`` at each block's start, after its products, after the
split's exchange and at its end, and at each k-tile and epilogue row of
the mainloop.  All variants build in parallel with the flags of
``kernels/_build.py`` into ``build/variants/`` and run, in turns, on the
same operands:

* ``fused_gemm_epilogue`` (SiLU) at the kernel bench's 256x512x256, with
  the K split forced to 1, 2, 4, 8 and left to ``k_splits``, and at
  2048x2048x2048, float32 and bfloat16, each call held against the plain
  version where the variant computes the full product;
* ``packed_gemm`` at the kernel bench's 4 groups, float32 and bfloat16.

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
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import chip_smoke

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
LIBS = ("fused_gemm_epilogue", "packed_gemm")

_STAMPS = """
__device__ unsigned long long g_probe[16384 * 64];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
"""
_READER = """
extern "C" int fused_probe_read(void* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, mma_gemm::g_probe, (size_t)n * 8);
}
"""
_SLOT = "mma_gemm::g_probe[(size_t)(blockIdx.x * gridDim.y + blockIdx.y) * 64"
_ITER = ("    __syncthreads();            // tile `it` landed; tile it-1's "
         "stage free\n")
_RING = "                                 ring);\n"
_SUMS = "  float* sums = tile_c + BM * LDC;\n"
_ROWS = "  // row r: its total + b, activation"
_STORE = "    mma_gemm::store4<T>((T*)a.out, m, n, a.N, y);\n"
_END = ('    asm volatile("barrier.cluster.wait;\\n" ::: "memory");\n'
        "}\n")
# per block, 64 slots: 0 start, 1 products done, 2 exchange done, 3 end;
# 8.. each k-tile's arrival; 56.. each epilogue row group's store
PROBE = [
    ("mma_gemm.cuh", "namespace mma_gemm {\n", "namespace mma_gemm {\n" +
     _STAMPS),
    ("mma_gemm.cuh", _ITER, _ITER + "    if (threadIdx.x == 0 && it < 48) "
     "g_probe[(size_t)(blockIdx.x * gridDim.y + blockIdx.y) * 64 + 8 + it]"
     " = gtime();\n"),
    ("fused_gemm_epilogue.cu", "}  // namespace\n",
     "}  // namespace\n" + _READER),
    ("fused_gemm_epilogue.cu", _SUMS,
     _SUMS + "  const unsigned long long t0 = mma_gemm::gtime();\n"),
    ("fused_gemm_epilogue.cu", _RING,
     _RING + "  const unsigned long long t1 = mma_gemm::gtime();\n"),
    ("fused_gemm_epilogue.cu", _ROWS,
     "  const unsigned long long t2 = mma_gemm::gtime();\n" + _ROWS),
    ("fused_gemm_epilogue.cu", _STORE, _STORE +
     f"    if (threadIdx.x == 0) {_SLOT} + 56 + i] = mma_gemm::gtime();\n"),
    ("fused_gemm_epilogue.cu", _END, _END[:-2] +
     f"  if (threadIdx.x == 0) {{ unsigned long long* p = &{_SLOT}];\n"
     "    p[0] = t0; p[1] = t1; p[2] = t2; p[3] = mma_gemm::gtime(); }\n"
     "}\n"),
]
_SPLIT_CVT = (
    "__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,\n"
    "                                           uint32_t& lo) {\n"
    "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(hi) : \"f\"(x));\n"
    "  const float r = x - __uint_as_float(hi);\n"
    "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(lo) : \"f\"(r));\n"
    "}\n")
_SPLIT = ("__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,\n"
          "                                           uint32_t& lo) {\n"
          "  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
          "  lo = __float_as_uint(x - __uint_as_float(hi));\n"
          "}\n")
_COMPUTE = ("    compute_stage<BM, BN>(acc, st, st + BM * C::LDA, wm0, wn0, "
            "lane);\n")
_LOAD_TOP = ("  constexpr int BK = C::BK, CH = C::CH;\n"
             "  const int tid = threadIdx.x;\n")
_PULL = "cluster.map_shared_rank(tile_c, q)"
_BARRIER = "    cluster.sync();\n#pragma unroll 1\n"
_SILU = "return y * (1.0f / (1.0f + expf(-y)));"
_ACT = "      y[j] = activate<ACT>(y[j] + bias[j]);"
_STAGES = "constexpr int STAGES = 4;"


def stages(n: int) -> list:
    return [("mma_gemm.cuh", _STAGES, f"constexpr int STAGES = {n};")]


# name -> (replacements, timing_only, libraries built)
VARIANTS = {
    "as committed": ([], False, LIBS),
    "probe": (PROBE, False, LIBS),
    "probe, mainloop without copies": (PROBE + [(
        "mma_gemm.cuh", _LOAD_TOP, _LOAD_TOP + "  if (K >= 0) return;\n")],
        True, LIBS),
    "probe, mainloop without products": (
        PROBE + [("mma_gemm.cuh", _COMPUTE, "")], True, LIBS),
    "probe, epilogue without activation": (PROBE + [(
        "fused_gemm_epilogue.cu", _ACT,
        "      y[j] = y[j] + bias[j];")], True, LIBS),
    "probe, 8 warps a block": (PROBE + [
        ("mma_gemm.cuh", "constexpr int THREADS = 128;",
         "constexpr int THREADS = 256;"),
        ("mma_gemm.cuh", "WARPS_N = 4 / WARPS_M;",
         "WARPS_N = 8 / WARPS_M;")], False, ("fused_gemm_epilogue",)),
    "TF32 split by cvt.rna": ([("mma_gemm.cuh", _SPLIT, _SPLIT_CVT)],
                              False, LIBS),
    "ring of 3": (stages(3), False, LIBS),
    "ring of 6": (stages(6), False, LIBS),
    "ring of 8": (stages(8), False, LIBS),
    "SiLU division as __frcp_rn": ([(
        "fused_gemm_epilogue.cu", _SILU,
        "return y * __frcp_rn(1.0f + expf(-y));")], False,
        ("fused_gemm_epilogue",)),
    "exchange without remote reads": ([(
        "fused_gemm_epilogue.cu", _PULL, "(tile_c + 0 * q)")], True,
        ("fused_gemm_epilogue",)),
    "exchange without the first cluster barrier": ([(
        "fused_gemm_epilogue.cu", _BARRIER, "#pragma unroll 1\n")], True,
        ("fused_gemm_epilogue",)),
}
FUSED_SHAPES = [(256, 512, 256), (2048, 2048, 2048)]
BENCH_GROUPS = chip_smoke.GROUP_SIZES[1]


def build_variant(name: str, build) -> dict:
    """Write the variant's sources under build/variants/ and build its
    libraries; returns {library name: path}."""
    reps, _, libs = VARIANTS[name]
    stem = "float_" + "".join(c if c.isalnum() else "_" for c in name)
    out_dir = os.path.join(ROOT, "build", "variants", stem)
    os.makedirs(out_dir, exist_ok=True)
    for f in ("mma_gemm.cuh", "float_io.cuh", *(f"{n}.cu" for n in LIBS)):
        src = open(os.path.join(CSRC, f)).read()
        for file, old, new in reps:
            if file == f:
                if old not in src:
                    raise SystemExit(f"variant {name!r}: {f} no longer "
                                     f"holds {old[:60]!r}")
                src = src.replace(old, new)
        with open(os.path.join(out_dir, f), "w") as fh:
            fh.write(src)
    out = {}
    for lib in libs:
        path = os.path.join(out_dir, f"lib{lib}.so")
        proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", path,
                               os.path.join(out_dir, f"{lib}.cu")],
                              capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name!r} {lib}:\n"
                             f"{proc.stderr}")
        out[lib] = path
    return out


def probe_report(lib, M: int, K: int, N: int, splits: int, chunk: int,
                 bk: int, row_step: int) -> str:
    """Phases of the last launch (``splits`` shares of ``chunk`` K
    elements, k-tiles of ``bk``, epilogue row groups of ``row_step``
    rows) from the probe's stamps."""
    tiles = -(-M // 64) * -(-N // 64)
    n = tiles * splits
    buf = (ctypes.c_ulonglong * (n * 64))()
    lib.fused_probe_read(buf, n * 64)
    rows = [buf[i * 64:(i + 1) * 64] for i in range(n)]
    t0 = min(r[0] for r in rows)
    phase = [statistics.median(r[k] - r[k - 1] for r in rows)
             for k in (1, 2, 3)]
    nt = -(-min(K, chunk) // bk)
    first = [r[8] - r[0] for r in rows]
    per_tile = [(r[8 + nt - 1] - r[8]) / (nt - 1) for r in rows] \
        if nt > 1 else [0.0]
    items = -(-(64 // splits) // row_step)
    epi = [(r[56 + items - 1] - r[2]) / items for r in rows]
    return (f"block starts spread {max(r[0] for r in rows) - t0} ns, "
            f"span {max(r[3] for r in rows) - t0} ns; median per block: "
            f"products {phase[0]:.0f} ns (first k-tile at "
            f"{statistics.median(first):.0f}, then "
            f"{statistics.median(per_tile):.0f} a k-tile over {nt}), "
            f"exchange {phase[1]:.0f}, epilogue {phase[2]:.0f} "
            f"({statistics.median(epi):.0f} a row group of {items})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("float_gemm_variants: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import (_build, fused_gemm_epilogue_ref,
                                     packed_gemm_tiles_ref, pad_groups,
                                     tile_group_map)
    fused = importlib.import_module("repro_torch.kernels.fused_gemm_epilogue")
    packed = importlib.import_module("repro_torch.kernels.packed_gemm")
    torch.backends.cuda.matmul.allow_tf32 = False
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(
            lambda n: build_variant(n, _build), VARIANTS)))
    print(chip_smoke.nvidia_smi(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        for M, K, N in FUSED_SHAPES:
            x = torch.randn(M, K, generator=gen, device=dev).to(dt)
            w = (torch.randn(K, N, generator=gen, device=dev) * .05).to(dt)
            b = torch.randn(N, generator=gen, device=dev)
            cases.append((dt, (M, K, N), x, w, b,
                          fused_gemm_epilogue_ref(x, w, b)))
    groups = []
    for dt in (torch.float32, torch.bfloat16):
        wg = (torch.randn(4, 128, 256, generator=gen, device=dev) * .1
              ).to(dt)
        xg = torch.randn(sum(BENCH_GROUPS), 128, generator=gen, device=dev
                         ).to(dt)
        xp, padded, _, _ = pad_groups(xg, BENCH_GROUPS, 128)
        tiles = tile_group_map(padded, 128, xp.shape[0] // 128).to(dev)
        groups.append((dt, xp, wg, tiles,
                       packed_gemm_tiles_ref(xp, wg, tiles, 128)))
    summary = {}
    for name, paths in libs.items():
        _, timing_only, _ = VARIANTS[name]
        flib = fused.declare(ctypes.CDLL(paths["fused_gemm_epilogue"]))
        fused._lib = lambda lib=flib: lib
        row, notes = {}, []
        for dt, (M, K, N), x, w, b, ref in cases:
            tag = f"{str(dt).split('.')[-1]} {M}x{K}x{N}"
            auto = fused.k_splits(M, N, K, x.element_size())[0]
            if not timing_only:
                err = (fused._launch(x, w, b, None, "silu").float()
                       - ref.float()).abs().max().item()
                tol = 1e-4 if dt == torch.float32 else 2e-2
                chip_smoke.check(err <= tol + tol * ref.abs().max().item(),
                                 f"variant {name!r} {tag}: max err {err}")
            forced = (1, 2, 4, 8) if M < 2048 else ()
            for s in (*forced, None):
                key = f"{tag} split {s or f'auto {auto}'}"
                row[key] = chip_smoke.device_ms(
                    lambda: fused._launch(x, w, b, None, "silu", splits=s))
            if name.startswith("probe") and M < 2048:
                bk = 32 if dt == torch.float32 else 64
                row_step = 16 if "8 warps" in name else 8
                for s in sorted({1, auto}):
                    chunk = fused.k_splits(M, N, K, x.element_size(), s)[1]
                    fused._launch(x, w, b, None, "silu", splits=s)
                    torch.cuda.synchronize()
                    notes.append(f"{tag} split {s}: " + probe_report(
                        flib, M, K, N, s, chunk, bk, row_step))
        if "packed_gemm" in paths:
            plib = packed.declare(ctypes.CDLL(paths["packed_gemm"]))
            packed._lib = lambda lib=plib: lib
            for dt, xp, wg, tiles, ref in groups:
                key = f"packed {str(dt).split('.')[-1]} 4 groups"
                if not timing_only:
                    got = packed._launch(xp, wg, tiles, 128)
                    chip_smoke.check(bool(torch.allclose(
                        got.float(), ref.float(), rtol=2e-2, atol=2e-2)),
                        f"variant {name!r} {key} differs")
                row[key] = chip_smoke.device_ms(
                    lambda: packed._launch(xp, wg, tiles, 128))
        summary[name] = dict(times=row, probe=notes)
        print(f"{name}{' (timing only)' if timing_only else ''}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in row.items()), flush=True)
        for line in notes:
            print(f"  probe {line}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": chip_smoke.nvidia_smi(), "variants": summary},
                      f, indent=1)
    print(json.dumps({"variants": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
