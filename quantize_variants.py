"""Time ``quantize_layout``'s paths and variants on the card.

Usage, from the repository root on a machine with the GPU::

    python3 quantize_variants.py [--paths] [--variants] [--probe] [--out FILE]

Every mode runs the executor's own calls: ResNet-18 at batches 1, 3 and 16
and vit_tiny at 16, compiled on the card and driven once eagerly
(``chip_smoke.record_stages``), each call held ``torch.equal`` to the
plain version.

* ``--paths`` times every call (``chip_smoke.device_ms``) under settings
  of the wrapper's path constants (``PATHS``: its own choice, every call
  forced to one launch or to the multi-pass path, other grid sizes) and
  prints the sum per forward; per call on ``--out`` (or standard error).
* ``--variants`` builds textual variants of ``csrc/quantize_layout.cu``
  (``VARIANTS``: other gather tile counts and grids, a deeper unroll)
  into ``build/variants/`` and times each, in turns, on the same calls.
  Its anchors are exact source lines: a variant whose anchor moved exits
  with a message naming it.
* ``--probe`` builds a variant that stamps ``%globaltimer`` at each
  block's start and end and ``clock64`` at the one-launch conv kernel's
  phase boundaries, runs one call of some geometries on each path and
  prints each kernel's span and the median cycles at each stamp.

Exits 1 without a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                    "quantize_layout.cu")
OUT_DIR = os.path.join(ROOT, "build", "variants")
NETS = (("resnet18", (1, 3, 16)), ("vit_tiny", (16,)))

# settings of the wrapper's module constants, by name
PATHS = {
    "auto": {},
    "one-launch": {"ONE_LAUNCH_MAX": 2 ** 31},
    "one-launch, 64 blocks": {"ONE_LAUNCH_MAX": 2 ** 31,
                              "MAX_ONE_BLOCKS": 64},
    "one-launch, 256 blocks": {"ONE_LAUNCH_MAX": 2 ** 31,
                               "MAX_ONE_BLOCKS": 256},
    "one-launch, 8192 a block": {"ONE_LAUNCH_MAX": 2 ** 31,
                                 "AMAX_PER_BLOCK": 8192},
    "multi-pass": {"ONE_LAUNCH_MAX": -1},
    "multi-pass, 2048 a partial": {"ONE_LAUNCH_MAX": -1, "PART_ELEMS": 2048},
    "multi-pass, 8192 a partial": {"ONE_LAUNCH_MAX": -1, "PART_ELEMS": 8192},
}

_TILES = "one_launch ? blocks * cluster : 2 * sms, &T)"
_GRID = ("DependentLaunch ga(dim3(blocks_for(T.count, 1, MAX_BLOCKS)), "
         "smem, s);")
VARIANTS = {
    "base": [],
    "gather tiles 1 a SM": [(_TILES, _TILES.replace("2 * sms", "sms"))],
    "gather tiles 4 a SM": [(_TILES, _TILES.replace("2 * sms", "4 * sms"))],
    "gather tiles 8 a SM": [(_TILES, _TILES.replace("2 * sms", "8 * sms"))],
    "gather grid 2 a SM": [(_GRID, _GRID.replace(
        "MAX_BLOCKS", "2 * sms"))],
    "unroll 8": [("constexpr int UNROLL = 4; ", "constexpr int UNROLL = 8; ")],
}

# the probe variant: per kernel (0 one_conv, 1 partials_conv, 2 image,
# 3 gather) and block, [0] start and [1] end (%globaltimer, ns) and
# [2..7] clock64 cycles from the start at the stamps
_PROBE_HEAD = """namespace cg = cooperative_groups;
__device__ unsigned long long g_probe[4][4096][8];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PSTART(K) const unsigned long long _gt0 = gtime(); \\
  const long long _c0 = clock64(); const int _pk = K; \\
  const unsigned _pb = blockIdx.x + blockIdx.y * gridDim.x;
#define PSTAMP(I) if (threadIdx.x == 0 && _pb < 4096) \\
  g_probe[_pk][_pb][I] = clock64() - _c0;
#define PEND() if (threadIdx.x == 0 && _pb < 4096) { \\
  g_probe[_pk][_pb][0] = _gt0; g_probe[_pk][_pb][1] = gtime(); }
"""
PROBE = [
    ("namespace cg = cooperative_groups;\n", _PROBE_HEAD),
    ("  const float m = block_max(g.walk4 ? conv_abs_max<4>(g, rank, size)",
     "  PSTART(0)\n"
     "  const float m = block_max(g.walk4 ? conv_abs_max<4>(g, rank, size)"),
    ("  if (size > 1) cluster_post(m, &slot);\n  unsigned short* table",
     "  PSTAMP(2)\n"
     "  if (size > 1) cluster_post(m, &slot);\n  unsigned short* table"),
    ("  const float amax = size > 1 ? cluster_gather(&slot, cluster) : m;\n"
     "  if (blockIdx.x == 0 && threadIdx.x == 0) write_result(res, 0, amax);",
     "  PSTAMP(4)\n"
     "  const float amax = size > 1 ? cluster_gather(&slot, cluster) : m;\n"
     "  PSTAMP(3)\n"
     "  if (blockIdx.x == 0 && threadIdx.x == 0) write_result(res, 0, amax);"),
    ("    __syncthreads();\n    write_tile(st, table, g, L, T.rp, a, out);\n"
     "    __syncthreads();\n  }\n  if (size > 1) cluster_done();\n}",
     "    __syncthreads();\n    PSTAMP(5)\n"
     "    write_tile(st, table, g, L, T.rp, a, out);\n"
     "    __syncthreads();\n    PSTAMP(6)\n  }\n"
     "  if (size > 1) cluster_done();\n  PSTAMP(7)\n  PEND()\n}"),
    ("partials_conv_kernel(Conv g, float* partials) {\n",
     "partials_conv_kernel(Conv g, float* partials) {\n  PSTART(1)\n"),
    ("  if (threadIdx.x == 0) partials[blockIdx.x] = b;\n}",
     "  if (threadIdx.x == 0) partials[blockIdx.x] = b;\n  PEND()\n}"),
    ("             int parts, int8_t* img, unsigned short* table) {\n"
     "  if (g.walk4)",
     "             int parts, int8_t* img, unsigned short* table) {\n"
     "  PSTART(2)\n  if (g.walk4)"),
    ("    image_pass<1>(g, L, rp, res, partials, parts, img, table);\n}",
     "    image_pass<1>(g, L, rp, res, partials, parts, img, table);\n"
     "  PEND()\n}"),
    ("              const unsigned short* table_g, int8_t* out) {\n",
     "              const unsigned short* table_g, int8_t* out) {\n"
     "  PSTART(3)\n"),
    ("    write_tile(st, table, g, L, T.rp, a, out);\n    __syncthreads();\n"
     "  }\n}",
     "    write_tile(st, table, g, L, T.rp, a, out);\n    __syncthreads();\n"
     "  }\n  PEND()\n}"),
]
_PROBE_TAIL = """
extern "C" int read_probe(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_probe, sizeof(g_probe));
}
extern "C" int clear_probe() {
  static unsigned long long z[4][4096][8];
  return (int)cudaMemcpyToSymbol(g_probe, z, sizeof(z));
}
"""
PROBE_NAMES = ("one_conv", "partials", "image", "gather")
# (batch, stage index) of ResNet-18 that --probe runs
PROBE_CALLS = ((1, 1), (1, 17), (3, 7), (16, 0), (16, 1), (16, 12), (16, 17))


def build(name: str, subs: list) -> ctypes.CDLL:
    """``csrc/quantize_layout.cu`` with ``subs`` applied, built and loaded
    with the wrapper's signatures."""
    qmod = importlib.import_module("repro_torch.kernels.quantize_layout")
    src = open(CSRC).read()
    for old, new in subs:
        if src.count(old) != 1:
            sys.exit(f"quantize_variants: the anchor of {name!r} is not one "
                     f"line of the source: {old[:60]!r}")
        src = src.replace(old, new)
    if name == "probe":
        src += _PROBE_TAIL
    os.makedirs(OUT_DIR, exist_ok=True)
    stem = os.path.join(OUT_DIR, "".join(
        c if c.isalnum() else "_" for c in name))
    with open(stem + ".cu", "w") as f:
        f.write(src)
    from repro_torch.kernels import _build
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    os.path.dirname(CSRC), "-o", stem + ".so", stem + ".cu"],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(stem + ".so")
    for fn, types in qmod.SIGNATURES.items():
        getattr(lib, fn).argtypes = types
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def executor_calls(dev) -> list:
    """(net, batch, stage, x, K, kwargs, plain version's outputs) of every
    ``quantize_layout`` call of ``NETS``' eager forwards on the card,
    without the partial maxima a call took from its input's epilogue (the
    paths timed here reduce their own amax)."""
    import torch
    import chip_smoke as cs
    from repro_torch import api
    qmod = importlib.import_module("repro_torch.kernels.quantize_layout")
    gen = torch.Generator(device=dev).manual_seed(31)
    calls = []
    for net, batches in NETS:
        model = api.compile(net, api.HurryConfig(), seed=0, device="cuda")
        for b in batches:
            x = torch.randn(model.program.input_shape(b), generator=gen,
                            device=dev)
            for i, rec in enumerate(cs.record_stages(model, x)[1]):
                for xin, K, kw, _ in rec["quants"]:
                    kw = {k: v for k, v in kw.items() if k != "partials"}
                    calls.append((net, b, i, xin, K, kw,
                                  qmod.quantize_layout_ref(xin, K, **kw)))
    return calls


def timed(calls, settings: dict, log, label: str) -> dict:
    """Device ms per forward of ``calls`` under each setting (a dict of
    the wrapper's constants, or a built library), every call held equal
    to the plain version; per call on ``log``."""
    import torch
    import chip_smoke as cs
    qmod = importlib.import_module("repro_torch.kernels.quantize_layout")
    saved = {k: getattr(qmod, k) for k in ("_lib", *{
        k for s in settings.values() if isinstance(s, dict) for k in s})}
    sums: dict = {}
    for net, b, i, xin, K, kw, want in calls:
        row = []
        for name, s in settings.items():
            for k, v in saved.items():
                setattr(qmod, k, v)
            if isinstance(s, dict):
                for k, v in s.items():
                    setattr(qmod, k, v)
            else:
                qmod._lib = lambda lib=s: lib
            got = qmod.quantize_layout(xin, K, **kw)
            cs.check(all(torch.equal(a, w) for a, w in zip(got, want)),
                     f"{label} {name}: {net} b{b} stage {i} differs from "
                     "the plain version")
            ms = cs.device_ms(lambda: qmod.quantize_layout(xin, K, **kw))
            sums[(net, b, name)] = sums.get((net, b, name), 0.0) + ms
            row.append(f"{name} {ms * 1e3:.1f}")
        for k, v in saved.items():
            setattr(qmod, k, v)
        geo = {k: v for k, v in kw.items()
               if k in ("rows", "adc_bits", "conv", "per_slice")}
        pl = qmod.plan(xin, K, **geo)
        print(f"{label} {net} b{b} stage {i} {tuple(xin.shape)} K={K} "
              f"{geo} covered {cs.quant_covered(xin, kw)} (auto: "
              f"{'one launch' if pl.one_launch else 'multi-pass'}), us: "
              + ", ".join(row), file=log, flush=True)
    return sums


def probe(calls) -> None:
    """One call of each ``PROBE_CALLS`` geometry on each path, through the
    probe variant: each kernel's blocks, span and median stamp cycles."""
    import torch
    qmod = importlib.import_module("repro_torch.kernels.quantize_layout")
    lib = build("probe", PROBE)
    lib.read_probe.argtypes = [ctypes.c_void_p]
    saved = qmod._lib, qmod.ONE_LAUNCH_MAX
    qmod._lib = lambda: lib
    buf = np.zeros((4, 4096, 8), dtype=np.uint64)
    try:
        for b, i in PROBE_CALLS:
            _, _, _, xin, K, kw, _ = next(
                c for c in calls if c[0] == "resnet18" and c[1] == b
                and c[2] == i)
            for one in (True, False):
                qmod.ONE_LAUNCH_MAX = 2 ** 31 if one else -1
                qmod.quantize_layout(xin, K, **kw)
                torch.cuda.synchronize()
                lib.clear_probe()
                qmod.quantize_layout(xin, K, **kw)
                torch.cuda.synchronize()
                lib.read_probe(buf.ctypes.data)
                ran = [k for k in range(4) if (buf[k, :, 0] > 0).any()]
                t0 = min(int(buf[k, buf[k, :, 0] > 0, 0].min()) for k in ran)
                parts = []
                for k in ran:
                    sel = buf[k, :, 0] > 0
                    st = buf[k, sel, 0].astype(np.int64) - t0
                    en = buf[k, sel, 1].astype(np.int64) - t0
                    med = np.median(buf[k, sel, 2:8].astype(np.int64),
                                    axis=0).astype(int).tolist()
                    parts.append(
                        f"{PROBE_NAMES[k]} {int(sel.sum())} blocks: start "
                        f"{st.min()}..{st.max()} ns, end {en.min()}.."
                        f"{en.max()} ns"
                        + (f", median cycles at stamps 2-7 {med}"
                           if k == 0 else ""))
                print(f"[probe] resnet18 b{b} stage {i} {tuple(xin.shape)} "
                      f"{'one launch' if one else 'multi-pass'}: "
                      + "; ".join(parts), flush=True)
    finally:
        qmod._lib, qmod.ONE_LAUNCH_MAX = saved


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--paths", action="store_true")
    parser.add_argument("--variants", action="store_true")
    parser.add_argument("--probe", action="store_true")
    parser.add_argument("--out", help="per-call lines (default: stderr)")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("quantize_variants: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import _build
    with ThreadPoolExecutor(len(_build.SOURCES)) as pool:
        list(pool.map(_build.build, _build.SOURCES))
    print(cs.nvidia_smi(), flush=True)
    calls = executor_calls(torch.device("cuda"))
    log = open(args.out, "w") if args.out else sys.stderr
    runs = []
    if args.paths:
        runs.append(("paths", timed(calls, PATHS, log, "paths")))
    if args.variants:
        libs = {name: build(name, subs) for name, subs in VARIANTS.items()}
        runs.append(("variants", timed(calls, libs, log, "variants")))
    for label, sums in runs:
        for (net, b, name), ms in sums.items():
            print(f"[{label}] {net} b{b} {name}: {ms:.4f} ms per forward",
                  flush=True)
    if args.probe:
        probe(calls)
    return 0


if __name__ == "__main__":
    sys.exit(main())
