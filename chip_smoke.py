#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and hold its kernels.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

It needs one CUDA GPU, ``nvcc`` and the repository's ``src/`` beside it,
and exits nonzero (printing no result) without them.  Phases, one line
each on standard output (the per-shape details go to standard error):

1. device: name and power limit (``nvidia-smi``), torch/CUDA versions,
   and the seconds to build the kernels (one ``nvcc`` each, in
   parallel); ``crossbar_gemm``'s SASS must hold int8 tensor-core
   (``IGMMA``) instructions and no ``IDP.4A`` or ``POPC``, and
   ``fused_gemm_epilogue``'s and ``packed_gemm``'s float tensor-core ones
   (``HMMA``, or ``HGMMA``);
2. ``crossbar_gemm`` exact branch, equal to the plain version
   (``torch.equal``): ResNet-18's stage shapes (batch 16) in the main
   path's form (x in the kernel layout, the packed ``wt``), ragged
   shapes, M in 1/4/16 x K in 27/101/988/1458/4860 x N in 10/19/77,
   all -128 operands, and the K split on and off for one shape;
3. ``crossbar_gemm`` sliced branch (8-bit ADC / 494 rows, 9-bit / 512,
   every chunk height 247/486/494/511/512 at M = 1, 4, 16) on inputs
   where clips fire, all -1 operands, and the chunk split on and off,
   equal to the plain version;
4. ``fb_epilogue`` in every mode against the plain version, to the
   tolerances in ``FB_CASES`` (``torch.equal`` where the tolerance is 0),
   at each mode's own width and at N = 64/192/768 (16-byte path) and
   10/19/77 (scalar path), the row modes also at N = 1024 (a warp per
   row) and 1025 (a block per row);
5. the main path: ``repro_torch.api.compile("resnet18", HurryConfig())``
   at full width, serving request batches of 1, 3 and 16, checked
   against the same weights run on the CPU's plain path; both launch
   counters must grow by one per stage and request;
6. the sliced branch end to end: AlexNet under ``HurryConfig(adc_bits=8)``
   at batch 4 against the CPU's plain path;
7. times: each kernel summed over one batch-16 forward's shapes, and
   the GEMM over a batch-1 forward's as well (device time per call from
   25 calls captured in a CUDA graph, median of 5 replays,
   ``device_ms``), beside its bound, its plain version and, for the GEMM,
   ``torch._int_mm`` with the weight row-major and K-major; the five
   stages furthest from their bound at each batch, for the GEMM and for
   ``fb_epilogue``; and
   ResNet-18's end-to-end time per batch at 1 and 16 (host clock around
   ``run`` and a device synchronize, median of 10), with the device's
   busy time (profiler device events) and idle share of those forwards
   (``forward_profile``);
8. the batched launches at vit_tiny's dynamic shapes (48 slices of
   64x64x64): ``crossbar_gemm`` on both branches and ``fb_epilogue``
   (scores: softmax + post_scale; context: plain dequant) in one launch
   each, equal to the plain versions on the same inputs and to the
   per-slice 2-D calls (``torch.equal``; softmax to 1e-6), and 5 ragged
   slices of 16x1001x19 through a mounted weight;
9. ``flash_attention`` against its plain version: float32 at
   (1,128,1,64) and (2,256,4,64) causal and not, a 128-key window at
   (1,512,2,64), vit's (16,64,3,64), the attention path's (1,T,4,16) for
   T = 16, 64, 256, head dims 16/32/128, a ragged last key tile, head
   dims below their instantiation and rows that are not 16-byte aligned,
   and shapes on both sides of the key-split threshold, to 1e-4; bfloat16
   at every head dim and (1,512,4,64) to 2e-2; the key split forced off
   and on at (1,512,4,64), two runs of the split ``torch.equal``, and the
   merged output against the split's plain version
   (``flash_attention_split_ref``); GQA through ``ops.attention`` at
   (1,256,8,64) with 2 kv heads;
10. ``fused_gemm_epilogue`` against its plain version at 128x256x128,
    256x512x384, 128x1024x256 and 256x512x256 and the ragged, unaligned
    1x7x3, 77x1001x19 and 130x514x258, every activation, with and
    without residual, float32 (1e-4) and bfloat16 (2e-2); at 256x512x256
    the K split forced off and left on, two split runs ``torch.equal``;
11. ``packed_gemm`` against its plain version, and ``ops.grouped_gemm``
    against ``packed_gemm_ref``, for the group sizes of
    ``tests/test_kernels.py`` (the second is the kernel bench's case),
    K=128, N=256, and at block_m 32/64/96 with the tile map [2, 0, 2, 1],
    float32 (1e-4) and bfloat16 (2e-2);
12. the sequence path: ``repro_torch.api.compile("vit_tiny")`` at full
    width (dim 192, 3 heads, depth 2, 64 tokens) serving batches 1, 3
    and 16 against the CPU plain path (argmax agreement 1.0, logits to
    a relative 1e-2, probabilities to 1e-3); every
    dynamic stage makes exactly one ``crossbar_gemm`` and one
    ``fb_epilogue`` launch; time per batch at 1 and 16 and the device's
    idle share, as in 7; then batch 16 on three further input draws
    (``VIT_DRAWS``), each draw's max relative logit gap and argmax
    agreement printed, and on the draw with the largest gap every stage
    teacher-forced on the card from the CPU path's buffers (int32 GEMM
    outputs ``torch.equal``, FB outputs within ``FB_CASES``' tolerances)
    and the int8 GEMM operands of the free-running forward that differ
    from the CPU path's, stage by stage (standard error);
13. the attention path: one ``attention(4)`` layer (dim 64, batch 1,
    ``HurryConfig(array_rows=511)``) at T = 16, 64, 256 through
    ``api.compile(...).run``, against ``ops.attention(causal=False)``
    on the same projected q/k/v followed by the same output projection
    (relative error < 0.12, correlation > 0.99), with both times;
14. the ops entry point: ``repro_torch.kernels.ops``' five wrappers at
    the kernel bench's shapes, each launching its kernel once and
    agreeing with its plain version;
15. times of the new kernels and of vit_tiny's dynamic stages, as in 7,
    with ``F.scaled_dot_product_attention`` as the attention yardstick;
    ``flash_attention`` also at ``FLASH_TIMED`` (float32 (1,512,4,64)
    causal and not, (16,64,3,64), bfloat16 (1,512,4,64) causal and not),
    each beside SDPA; ``fused_gemm_epilogue`` and ``packed_gemm`` at
    ``FUSED_TIMED`` / ``PACKED_TIMED`` (the kernel bench's shapes and
    2048x2048x2048 / 8 ragged groups of 4096 rows, K 1024, N 1024), in
    float32 and bfloat16, beside ``torch.addmm`` (bias only; for ReLU also
    ``torch._addmm_activation``, the same function), a per-group
    ``torch.matmul`` loop and ``torch._grouped_mm`` where this torch takes
    the case.

The line before the last is the JSON record of the kernels; the last is
``{"ok": true, "device": {...}}``.  Any failed check raises before it.

``python3 chip_smoke.py --kernel-times [--src DIR] [--label NAME]`` only
times ``fb_epilogue``, ``flash_attention``, ``fused_gemm_epilogue`` and
``packed_gemm`` (``kernel_times``) for the ``repro_torch`` under ``DIR``:
run on a ``git archive`` of a parent commit and on this tree in one
call, it compares the two on one card.
"""

from __future__ import annotations

import importlib
import json
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA's data sheet
INT8_OPS_PER_S = 1979e12         # dense int8 tensor-core peak
F32_OPS_PER_S = 67e12            # float32 outside the tensor cores
BF16_OPS_PER_S = 989e12          # dense bf16 tensor-core peak
ATTN_T = (16, 64, 256)           # the attention bench's sequence lengths
GROUP_SIZES = ([256, 128, 384], [200, 56, 300, 100], [128], [0, 256, 0, 128])
TIMED_LAUNCHES = 25
# (mode name, fb_epilogue kwargs, needs residual, atol, reason).  atol 0
# means bit for bit: the kernel and the plain version round the same
# operations in the same order.
FB_CASES = [
    ("none", dict(), False, 0.0, "same roundings"),
    ("relu", dict(act="relu"), False, 0.0, "same roundings"),
    ("relu+residual", dict(act="relu"), True, 0.0, "same roundings"),
    ("post_scale", dict(post_scale=0.125), False, 0.0, "same roundings"),
    ("maxpool", dict(act="relu", pool="max", window=2, img_hw=32), False,
     0.0, "max is exact"),
    ("avgpool", dict(act="relu", pool="avg", window=4, img_hw=4), True,
     0.0, "same summation order"),
    ("gelu", dict(act="gelu"), False, 1e-6, "tanhf vs torch.tanh"),
    ("layer", dict(norm="layer"), True, 1e-5, "order of the row sums"),
    ("seqmean", dict(act="gelu", norm="layer", pool="seqmean", window=64),
     True, 1e-5, "order of the row and token sums"),
    ("softmax", dict(softmax=True), False, 1e-6, "order of the row sum"),
]


# phase 4's widths beside each mode's own: the 16-byte path (N % 4 == 0,
# the program's widths) and the scalar one; the row modes also at the
# longest row a warp holds and one past it (the block-per-row path)
FB_WIDTHS = (64, 192, 768, 10, 19, 77)
FB_ROW_WIDTHS = (1024, 1025)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(line: str) -> None:
    """A phase line, on standard output."""
    print(line, flush=True)


def detail(line: str) -> None:
    """A per-shape detail, on standard error."""
    print(line, file=sys.stderr, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "nvidia-smi: " + out.stderr.strip()


def device_ms(fn, calls: int = TIMED_LAUNCHES, replays: int = 5) -> float:
    """Device time per call of ``fn``, without the host's launch gaps.

    After 3 warm-up calls on a side stream, ``calls`` calls are captured
    in one CUDA graph; the graph is replayed ``replays`` times between
    two CUDA events, and the median replay time over ``calls`` is the
    time of one call.
    """
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def forward_profile(fn, runs: int = 3) -> tuple[float | None, list]:
    """(device-busy ms, top kernels) per call of a forward, or (None, [])
    when the profiler sees no device events.

    Busy time is the summed duration of the device's kernels and copies
    per call (profiler device events); a first short session warms the
    profiler up.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        fn()
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t = by_name.setdefault(e.name[:60], [0.0, 0])
            t[0] += e.time_range.elapsed_us() / 1e3 / runs
            t[1] += 1
    if not by_name:
        return None, []
    kernels = sorted(((ms, n // runs, name) for name, (ms, n)
                      in by_name.items()), reverse=True)
    return sum(ms for ms, _, _ in kernels), kernels[:8]


def wall_ms(fn, runs: int = 10) -> float:
    """Median host-clock time of ``fn`` ending in a device synchronize."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def events_ms(fn, calls: int = TIMED_LAUNCHES) -> float:
    """Time per call of ``fn`` between two CUDA events around ``calls``
    calls, after 3 warm-ups: for functions that synchronize with the host
    and cannot be captured in a graph (launch gaps included)."""
    import torch
    for _ in range(3):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def sass_opcodes(build, name: str) -> dict | None:
    """Counts of the tensor-core (IGMMA int8 warpgroup, HMMA / HGMMA
    float), dot-product (IDP.4A) and popcount (POPC) instructions in a
    kernel library's SASS, from ``cuobjdump -sass`` beside ``nvcc``;
    None where there is none."""
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", str(build.library_path(name))],
                         capture_output=True, text=True, timeout=120).stdout
    return {op: len(re.findall(pattern, out)) for op, pattern in (
        ("IGMMA", r"\bIGMMA\."), ("HMMA", r"\bHMMA\."),
        ("HGMMA", r"\bHGMMA\."), ("IDP4A", r"\bIDP\.4A"),
        ("POPC", r"\bPOPC\b"))}


def gemm_bound(M: int, N: int, K: int, sliced: bool) -> tuple[float, float]:
    """(bytes-bound ms, operations-bound ms) of one crossbar GEMM.

    Bytes: each int8 operand read once, the int32 output written once.
    Operations: 2*M*N*K int8 ops; the sliced branch's per-plane counts
    are 64 {0,1} products of the same size, counted as int8 ops.
    """
    nbytes = M * K + K * N + 4 * M * N
    ops = 2 * M * N * K * (64 if sliced else 1)
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3


def int_mm_ms(x, w) -> tuple[float, float]:
    """``torch._int_mm``'s device time on (M, K) x (K, N) int8, padded to
    its shape rules (M > 16, K and N multiples of 8): with the weight
    row-major (K, N), then K-major (the transpose of an (N, K) contiguous
    tensor: the layout cuBLASLt's int8 kernels take)."""
    import torch
    F = torch.nn.functional
    (M, K), N = x.shape, w.shape[1]
    xl = F.pad(x, (0, -K % 8, 0, max(0, 17 - M))).contiguous()
    wl = F.pad(w, (0, -N % 8, 0, -K % 8)).contiguous()
    wk = wl.t().contiguous()
    return (device_ms(lambda: torch._int_mm(xl, wl)),
            device_ms(lambda: torch._int_mm(xl, wk.t())))


def fb_bound(M: int, N: int, out_rows: int, has_res: bool) -> float:
    """Bytes-bound ms of one epilogue: the int32 input (and the residual)
    and the bias read once, the f32 output written once."""
    nbytes = 4 * M * N * (2 if has_res else 1) + 4 * N + 4 * out_rows * N
    return nbytes / HBM_BYTES_PER_S * 1e3


def stage_shapes(model, batch: int) -> list[dict]:
    """Per-stage (M, K, N, rows, epilogue kwargs) of a batch's forward."""
    out = []
    for (gemm, posts), st in zip(model.program.stages(), model.packed.stages):
        M = batch * gemm.out_hw ** 2 if gemm.is_conv else batch
        kw, has_res, n_out = {}, False, M
        for op in posts:
            if op.kind == "relu":
                kw["act"] = "relu"
            elif op.kind == "residual":
                has_res = True
            elif op.kind in ("maxpool", "avgpool"):
                kw.update(pool="max" if op.kind == "maxpool" else "avg",
                          window=op.window, img_hw=op.in_hw)
                n_out = batch * op.out_hw ** 2
            elif op.kind == "softmax":
                kw["softmax"] = True
        out.append(dict(name=gemm.name, M=M, K=st.w8.shape[0],
                        N=st.w8.shape[1], rows=gemm.tile_rows, fb=kw,
                        res=has_res, out_rows=n_out, w8=st.w8, wt=st.wt))
    return out


def attn_bound(B: int, Sq: int, Sk: int, H: int, hd: int,
               causal: bool = False,
               dtype: str = "float32") -> tuple[float, float]:
    """(bytes-bound ms, operations-bound ms) of one attention: q, k, v
    read once and the output written once; 4*hd operations per (query,
    key) pair it sees (Sq*Sk, or the lower triangle when causal) per
    (b, h), at the float32 peak outside the tensor cores or the bf16
    tensor-core peak."""
    size, peak = (4, F32_OPS_PER_S) if dtype == "float32" else \
        (2, BF16_OPS_PER_S)
    nbytes = size * B * H * hd * (2 * Sq + 2 * Sk)
    pairs = sum(min(Sk, i + 1) for i in range(Sq)) if causal else Sq * Sk
    ops = 4 * B * H * pairs * hd
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3


# flash_attention's timed shapes beside SDPA (phase 15 and
# --kernel-times): (B, S, H, hd), causal, dtype
FLASH_TIMED = [((1, 512, 4, 64), False, "float32"),
               ((1, 512, 4, 64), True, "float32"),
               ((16, 64, 3, 64), False, "float32"),
               ((1, 512, 4, 64), False, "bfloat16"),
               ((1, 512, 4, 64), True, "bfloat16")]


def flash_times(dev, gen, attn_shapes=ATTN_T) -> dict:
    """Device times of ``flash_attention`` beside SDPA: the attention
    path's (1, T, 4, 16) summed over ``attn_shapes`` (non-causal,
    float32, with the plain version), and each ``FLASH_TIMED`` shape."""
    import torch
    from repro_torch.kernels import flash_attention, flash_attention_ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    path = dict(ms=0.0, plain=0.0, lib=0.0, by={"bytes": 0.0,
                                                  "operations": 0.0})
    for T in attn_shapes:
        q, k, v = (torch.randn(1, T, 4, 16, generator=gen, device=dev)
                   for _ in range(3))
        f_ms = device_ms(lambda: flash_attention(q, k, v, causal=False))
        f_plain = device_ms(lambda: flash_attention_ref(q, k, v,
                                                        causal=False))
        f_lib = device_ms(lambda: sdpa(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2)))
        b_ms, o_ms = attn_bound(1, T, T, 4, 16)
        path["by"]["bytes" if b_ms >= o_ms else "operations"] += max(b_ms,
                                                                     o_ms)
        path["ms"] += f_ms
        path["plain"] += f_plain
        path["lib"] += f_lib
        detail(f"time flash_attention (1,{T},4,16): {f_ms:.4f} ms (bound "
               f"{max(b_ms, o_ms):.5f}, plain {f_plain:.4f}, sdpa "
               f"{f_lib:.4f})")
    shapes = []
    for shape, causal, dt in FLASH_TIMED:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        f_ms = device_ms(lambda: flash_attention(q, k, v, causal=causal))
        f_lib = device_ms(lambda: sdpa(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), is_causal=causal))
        b_ms, o_ms = attn_bound(shape[0], shape[1], shape[1], shape[2],
                                shape[3], causal, dt)
        shapes.append(dict(shape=list(shape), causal=causal, dtype=dt,
                           ms=f_ms, sdpa_ms=f_lib, bound_ms=max(b_ms, o_ms)))
        detail(f"time flash_attention {shape} causal={causal} {dt}: "
               f"{f_ms:.4f} ms (bound {max(b_ms, o_ms):.5f}, sdpa "
               f"{f_lib:.4f})")
    return dict(path=path, shapes=shapes)


def fb_stage_times(shapes, dev, gen) -> dict:
    """``fb_epilogue``'s device time at each stage of a forward (the
    shapes of ``stage_shapes``), beside its byte bound and its plain
    version, summed; the five stages furthest from their bound go to
    standard error."""
    import torch
    from repro_torch.kernels import fb_epilogue, fb_epilogue_ref
    f = dict(ms=0.0, plain=0.0, bound=0.0, stages=[])
    for s in shapes:
        M, N = s["M"], s["N"]
        y = torch.randint(-2 ** 20, 2 ** 20, (M, N), generator=gen,
                          device=dev, dtype=torch.int32)
        scale = torch.full((1, 1), 3.1e-6, device=dev)
        bias = torch.randn(N, generator=gen, device=dev)
        res = torch.randn(M, N, generator=gen, device=dev) if s["res"] \
            else None
        f_ms = device_ms(lambda: fb_epilogue(y, scale, bias, res, **s["fb"]))
        f_plain = device_ms(lambda: fb_epilogue_ref(y, scale, bias, res,
                                                    **s["fb"]))
        f_bound = fb_bound(M, N, s["out_rows"], s["res"])
        f["ms"] += f_ms
        f["plain"] += f_plain
        f["bound"] += f_bound
        f["stages"].append((f_ms - f_bound, s["name"], f_ms, f_bound))
        detail(f"time fb_epilogue {s['name']}: M={M} N={N} {s['fb']} "
               f"res={s['res']} {f_ms:.4f} ms (bound {f_bound:.5f}, plain "
               f"{f_plain:.4f})")
    for gap, name, ms, bnd in sorted(f["stages"], reverse=True)[:5]:
        detail(f"top offender fb_epilogue {name}: {ms:.4f} ms, bound "
               f"{bnd:.5f}, gap {gap:.4f} ms")
    return f


def dyn_fb_times(dev, gen, S: int = 48, T: int = 64) -> dict:
    """``fb_epilogue``'s batched launches at vit_tiny's dynamic stages
    (b16: 48 slices of 64x64): the scores' softmax + post_scale and the
    context's dequant, summed as one (scores, context) pair."""
    import torch
    from repro_torch.kernels import fb_epilogue, fb_epilogue_ref
    y32 = torch.randint(-2 ** 16, 2 ** 16, (S, T, T), generator=gen,
                        device=dev, dtype=torch.int32)
    sc = torch.rand(S, 1, 1, generator=gen, device=dev) * 1e-4
    z = torch.zeros(T, device=dev)
    sm = dict(softmax=True, post_scale=0.125)
    return dict(
        ms=device_ms(lambda: fb_epilogue(y32, sc, z, **sm))
        + device_ms(lambda: fb_epilogue(y32, sc, z)),
        plain=device_ms(lambda: fb_epilogue_ref(y32, sc, z, **sm))
        + device_ms(lambda: fb_epilogue_ref(y32, sc, z)),
        bound=2 * fb_bound(S * T, T, S * T, False))


def float_gemm_bound(M: int, K: int, N: int, w_elems: int,
                     dtype: str = "float32",
                     bias: int = 0) -> tuple[float, float]:
    """(bytes-bound ms, operations-bound ms) of a float GEMM: x and w in
    ``dtype`` and ``bias`` float32 values read once, the output written
    once; 2*M*K*N operations at the float32 peak outside the tensor
    cores (float32) or the bf16 tensor-core peak (bfloat16)."""
    size, peak = (4, F32_OPS_PER_S) if dtype == "float32" else \
        (2, BF16_OPS_PER_S)
    nbytes = size * (M * K + w_elems + M * N) + 4 * bias
    return nbytes / HBM_BYTES_PER_S * 1e3, 2 * M * K * N / peak * 1e3


# fused_gemm_epilogue's and packed_gemm's timed cases (phase 15 and
# --kernel-times), each in GEMM_DTYPES: the kernel bench's shapes
# (benchmarks/kernels_bench.py) and one larger shape each
FUSED_TIMED = [((256, 512, 256), "silu"), ((256, 512, 256), "relu"),
               ((2048, 2048, 2048), "silu")]
PACKED_TIMED = [(GROUP_SIZES[1], 128, 256),
                ([700, 300, 612, 484, 388, 516, 596, 500], 1024, 1024)]
GEMM_DTYPES = ("float32", "bfloat16")


def _yardstick(fn) -> float | None:
    """A library call's device time (``device_ms``); where the call cannot
    be captured in a CUDA graph (``torch._grouped_mm`` in float32 copies
    to the host), its time by CUDA events around 25 calls, launch gaps
    included (``events_ms``); None where this torch refuses the call.
    The port never calls it."""
    import torch
    try:
        fn()
    except (RuntimeError, TypeError, NotImplementedError) as e:
        detail(f"  yardstick refused: {str(e).splitlines()[0][:120]}")
        return None
    try:
        return device_ms(fn)
    except RuntimeError as e:
        torch.cuda.synchronize()
        detail(f"  yardstick not capturable ({str(e).splitlines()[0][:80]}"
               "): timed by events, launch gaps included")
        return events_ms(fn)


def float_gemm_times(dev, gen) -> dict:
    """Device times of ``fused_gemm_epilogue`` (x (M, K), w (K, N) * 0.05,
    a float32 bias) at ``FUSED_TIMED`` and of ``packed_gemm`` (the kernel
    on ``pad_groups``' rows, block_m 128) at ``PACKED_TIMED``, each in
    float32 and bfloat16, beside their bounds, their plain versions and
    the library yardsticks: ``torch.addmm`` (the bias only; for ReLU
    also ``torch._addmm_activation``, the same function), a per-group
    ``torch.matmul`` loop, and ``torch._grouped_mm`` where this torch
    takes the case.  Uses only what the port had before its Hopper
    redesign, so it times another checkout's kernels too."""
    import numpy as np
    import torch
    from repro_torch.kernels import (fused_gemm_epilogue,
                                     fused_gemm_epilogue_ref,
                                     packed_gemm_tiles_ref, pad_groups,
                                     tile_group_map)
    packed_module = importlib.import_module("repro_torch.kernels.packed_gemm")
    fused, packed = [], []
    for (M, K, N), act in FUSED_TIMED:
        for dt in GEMM_DTYPES:
            dtype = getattr(torch, dt)
            x = torch.randn(M, K, generator=gen, device=dev).to(dtype)
            w = (torch.randn(K, N, generator=gen, device=dev) * .05).to(dtype)
            b = torch.randn(N, generator=gen, device=dev)
            bd = b.to(dtype)
            ms = device_ms(lambda: fused_gemm_epilogue(x, w, b, act=act))
            plain = device_ms(lambda: fused_gemm_epilogue_ref(x, w, b,
                                                              act=act))
            lib = {"addmm": _yardstick(lambda: torch.addmm(bd, x, w))}
            if act == "relu":
                lib["_addmm_activation"] = _yardstick(
                    lambda: torch._addmm_activation(bd, x, w))
            b_ms, o_ms = float_gemm_bound(M, K, N, K * N, dt, bias=N)
            row = dict(shape=[M, K, N], act=act, dtype=dt, ms=ms,
                       plain_ms=plain, library_ms=lib,
                       bound_ms=max(b_ms, o_ms),
                       bound_by="bytes" if b_ms >= o_ms else "operations")
            fused.append(row)
            detail(f"time fused_gemm_epilogue {M}x{K}x{N} {act} {dt}: "
                   f"{ms:.4f} ms (bound {row['bound_ms']:.5f} by "
                   f"{row['bound_by']}, plain {plain:.4f}, library {lib})")
    for sizes, K, N in PACKED_TIMED:
        G = len(sizes)
        for dt in GEMM_DTYPES:
            dtype = getattr(torch, dt)
            wg = (torch.randn(G, K, N, generator=gen, device=dev) * .1
                  ).to(dtype)
            xg = torch.randn(sum(sizes), K, generator=gen, device=dev
                             ).to(dtype)
            xp, padded, _, _ = pad_groups(xg, sizes, 128)
            tiles = tile_group_map(padded, 128, xp.shape[0] // 128)
            tiles_dev = tiles.to(dev)
            ms = device_ms(lambda: packed_module._launch(xp, wg, tiles_dev,
                                                         128))
            plain = events_ms(lambda: packed_gemm_tiles_ref(xp, wg, tiles,
                                                            128))
            ends = np.cumsum(padded.numpy())
            starts = np.concatenate([[0], ends[:-1]])
            lib = {"matmul loop": _yardstick(
                lambda: [xp[a:e] @ wg[i] for i, (a, e)
                         in enumerate(zip(starts, ends))])}
            grouped_mm = getattr(torch, "_grouped_mm", None)
            offs = torch.from_numpy(ends.astype(np.int32)).to(dev)
            lib["_grouped_mm"] = None if grouped_mm is None else _yardstick(
                lambda: grouped_mm(xp, wg, offs=offs))
            b_ms, o_ms = float_gemm_bound(sum(sizes), K, N, G * K * N, dt)
            row = dict(groups=G, rows=sum(sizes), K=K, N=N, dtype=dt, ms=ms,
                       plain_ms=plain, library_ms=lib,
                       bound_ms=max(b_ms, o_ms),
                       bound_by="bytes" if b_ms >= o_ms else "operations")
            packed.append(row)
            detail(f"time packed_gemm {G} groups {sum(sizes)} rows K {K} "
                   f"N {N} {dt}: {ms:.4f} ms (bound {row['bound_ms']:.5f} "
                   f"by {row['bound_by']}, plain {plain:.4f}, library "
                   f"{lib})")
    return dict(fused=fused, packed=packed)


EDGE_M = (1, 4, 16)
EDGE_K = (27, 101, 988, 1458, 4860)
EDGE_N = (10, 19, 77)
EDGE_ROWS = (247, 486, 494, 511, 512)


def _gemm_err(y, ref) -> int:
    return (y.long() - ref.long()).abs().max().item() if y.numel() else 0


def _split_on_and_off(dev, gen, exact: bool, M: int, K: int, N: int,
                      rows: int, adc: int) -> int:
    """One shape through the kernel with the K split it picks (> 1) and
    with none, both equal to the plain version; returns the split."""
    import torch
    from repro_torch.kernels import (crossbar_gemm_exact_ref,
                                     crossbar_gemm_ref, kernel_layout,
                                     mount_weight)
    module = importlib.import_module("repro_torch.kernels.crossbar_gemm")
    x = torch.randint(-128, 128, (M, K), generator=gen, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-128, 128, (K, N), generator=gen, device=dev,
                      dtype=torch.int8)
    x[: max(1, M // 4)] = -1
    w[:, : max(1, N // 4)] = -1
    kw = dict(rows=rows, adc_bits=adc, exact=exact)
    wt, xk = mount_weight(w, **kw), kernel_layout(x, K, **kw).contiguous()
    r = min(rows, K)
    split = module.splits(1, M, N, wt.shape[-1], exact=exact,
                          rows32=-(-r // 32) * 32)
    check(split > 1, f"no K split at M={M} K={K} N={N} exact={exact}")
    ref = crossbar_gemm_exact_ref(x, w) if exact else \
        crossbar_gemm_ref(x, w, adc_bits=adc, rows=rows)
    for forced in (0, 1):
        y = module._launch(xk, wt, N, exact=exact, rows=r, adc_bits=adc,
                           split=forced)
        check(torch.equal(y, ref), f"crossbar_gemm exact={exact} M={M} "
              f"K={K} N={N} split={'auto' if forced == 0 else 1} differs")
    return split


def gemm_exact_phase(dev, gen, shapes) -> tuple[int, int, int]:
    """Phase 2: the exact branch against its plain version: ResNet-18's
    stages in the main path's form (x laid out by ``kernel_layout``, the
    packed ``wt``), ragged shapes through a plain (K, N) weight, the edge
    shapes, all -128 (the largest |y|), and the K split on and off.
    Returns (max error, cases, the split of the split-on case)."""
    import torch
    from repro_torch.kernels import (crossbar_gemm, crossbar_gemm_exact_ref,
                                     kernel_layout)

    def rand_i8(*shape):
        return torch.randint(-128, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    worst, n = 0, 0
    for st in shapes:
        x = rand_i8(st["M"], st["K"])
        xk = kernel_layout(x, st["K"], rows=st["rows"])
        y = crossbar_gemm(xk, st["w8"], rows=st["rows"], wt=st["wt"])
        err = _gemm_err(y, crossbar_gemm_exact_ref(x, st["w8"]))
        worst, n = max(worst, err), n + 1
        check(err == 0, f"crossbar_gemm exact differs at stage {st['name']}")
    cases = [(1, 27, 10, 27), (37, 101, 19, 27), (1000, 494, 77, 494),
             (129, 1000, 65, 494), (3, 5, 3, 494)]
    cases += [(M, K, N, 511) for M in EDGE_M for K in EDGE_K for N in EDGE_N]
    for M, K, N, rows in cases:
        x, w = rand_i8(M, K), rand_i8(K, N)
        err = _gemm_err(crossbar_gemm(x, w, rows=rows),
                        crossbar_gemm_exact_ref(x, w))
        worst, n = max(worst, err), n + 1
        check(err == 0, f"crossbar_gemm exact differs at M={M} K={K} N={N}")
    x = torch.full((16, 4860), -128, dtype=torch.int8, device=dev)
    w = torch.full((4860, 77), -128, dtype=torch.int8, device=dev)
    y = crossbar_gemm(x, w, rows=511)
    check(bool((y == 4860 * 2 ** 14).all()), "crossbar_gemm exact on all "
          "-128 operands is not K * 2^14")
    split = _split_on_and_off(dev, gen, True, 256, 4860, 512, 486, 9)
    return worst, n + 2, split


def gemm_sliced_phase(dev, gen) -> tuple[int, int, int, int]:
    """Phase 3: the sliced branch against its plain version on inputs where
    clips fire (a quarter of the rows and columns all ones), every chunk
    height of the program and the smoke run at M = 1, 4, 16, all -1 (every
    count equals the chunk height), and the chunk split on and off.
    Returns (max error, cases, cases where a clip fired, the split)."""
    import torch
    from repro_torch.kernels import (clip_possible, crossbar_gemm,
                                     crossbar_gemm_exact_ref,
                                     crossbar_gemm_ref)
    cases = [(8, 494, 2048, 988, 64), (8, 494, 1024, 1976, 384),
             (9, 512, 512, 1536, 96), (9, 512, 33, 700, 17),
             (8, 486, 64, 4446, 1024)]
    cases += [(8, rows, M, 1458, 77) for rows in EDGE_ROWS for M in EDGE_M]
    worst = clipped = 0
    for adc, rows, M, K, N in cases:
        x = torch.randint(-128, 128, (M, K), generator=gen, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-128, 128, (K, N), generator=gen, device=dev,
                          dtype=torch.int8)
        x[: max(1, M // 4)] = -1             # all bits set: counts = rows
        w[:, : max(1, N // 4)] = -1
        y = crossbar_gemm(x, w, adc_bits=adc, rows=rows, exact=False)
        ref = crossbar_gemm_ref(x, w, adc_bits=adc, rows=rows)
        err = _gemm_err(y, ref)
        worst = max(worst, err)
        check(err == 0, f"crossbar_gemm sliced differs at "
              f"adc={adc} rows={rows} M={M} K={K} N={N}")
        fired = not torch.equal(ref, crossbar_gemm_exact_ref(x, w))
        check(fired == clip_possible(rows, adc), f"ADC clips at adc={adc} "
              f"rows={rows} M={M}: fired {fired}")
        clipped += int(fired)
    x = torch.full((16, 4860), -1, dtype=torch.int8, device=dev)
    w = torch.full((4860, 77), -1, dtype=torch.int8, device=dev)
    y = crossbar_gemm(x, w, adc_bits=8, rows=494, exact=False)
    check(torch.equal(y, crossbar_gemm_ref(x, w, adc_bits=8, rows=494)),
          "crossbar_gemm sliced differs on all -1 operands")
    split = _split_on_and_off(dev, gen, False, 4, 4374, 1024, 486, 8)
    return worst, len(cases) + 2, clipped + 1, split


def batched_phase(dev, gen) -> tuple[int, int, float]:
    """Phase 8: one batched launch at vit_tiny's dynamic shapes (batch 16
    x 3 heads, 64 tokens, hd 64), held against the plain versions on the
    same inputs and against the per-slice 2-D calls.  Returns the
    kernel-against-plain errors: exact GEMM, sliced GEMM, epilogue."""
    import torch
    from repro_torch.kernels import (crossbar_gemm, crossbar_gemm_ref,
                                     fb_epilogue, fb_epilogue_ref,
                                     mount_weight)
    S, T, hd = 16 * 3, 64, 64
    x = torch.randint(-128, 128, (S, T, hd), generator=gen, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-128, 128, (S, hd, T), generator=gen, device=dev,
                      dtype=torch.int8)
    x[:, :8] = -1                        # all bits set: counts reach rows
    w[:, :, :8] = -1
    gemm_err = {}
    for adc in (9, 5):                   # 64 rows: exact; then sliced
        before = crossbar_gemm.launches
        y = crossbar_gemm(x, w, adc_bits=adc, rows=hd)
        check(crossbar_gemm.launches - before == 1,
              "batched crossbar_gemm is not one launch")
        ref = crossbar_gemm_ref(x, w, adc_bits=adc, rows=hd)
        gemm_err[adc] = (y.long() - ref.long()).abs().max().item()
        check(torch.equal(y, ref), f"batched crossbar_gemm (adc {adc}) "
              f"differs from the plain version by {gemm_err[adc]}")
        per = torch.stack([crossbar_gemm(x[i], w[i], adc_bits=adc, rows=hd)
                           for i in range(S)])
        check(torch.equal(y, per), f"batched crossbar_gemm (adc {adc}) "
              "differs from the per-slice calls")
    # the slice axis at ragged M, K and N, through a mounted weight
    xr = torch.randint(-128, 128, (5, 16, 1001), generator=gen, device=dev,
                       dtype=torch.int8)
    wr = torch.randint(-128, 128, (5, 1001, 19), generator=gen, device=dev,
                       dtype=torch.int8)
    xr[:, :3] = -1
    wr[:, :, :4] = -1
    for adc, rows in ((9, 511), (8, 247), (8, 494)):
        wt = mount_weight(wr, rows=rows, adc_bits=adc, exact=False)
        y = crossbar_gemm(xr, wr, adc_bits=adc, rows=rows, exact=False,
                          wt=wt)
        check(torch.equal(y, crossbar_gemm_ref(xr, wr, adc_bits=adc,
                                               rows=rows)),
              f"batched ragged crossbar_gemm (adc {adc}, rows {rows}) "
              "differs from the plain version")
    y32 = torch.randint(-2 ** 16, 2 ** 16, (S, T, T), generator=gen,
                        device=dev, dtype=torch.int32)
    scale = torch.rand(S, 1, 1, generator=gen, device=dev) * 1e-4
    bias = torch.zeros(T, device=dev)
    fb_err = 0.0
    # the tolerances of FB_CASES: softmax to the order of the row sum,
    # the FMA dequant with the same roundings
    for kw, atol in ((dict(softmax=True, post_scale=0.125), 1e-6),
                     (dict(), 0.0)):
        before = fb_epilogue.launches
        out = fb_epilogue(y32, scale, bias, **kw)
        check(fb_epilogue.launches - before == 1,
              "batched fb_epilogue is not one launch")
        err = (out - fb_epilogue_ref(y32, scale, bias, **kw)).abs().max()
        fb_err = max(fb_err, err.item())
        check(err.item() <= atol, f"batched fb_epilogue {kw}: max "
              f"|kernel - plain| {err.item()} > {atol}")
        per = torch.stack([fb_epilogue(y32[i], scale[i], bias, **kw)
                           for i in range(S)])
        per_err = (out - per).abs().max().item()
        check(per_err <= atol, f"batched fb_epilogue {kw}: max |batched - "
              f"per-slice| {per_err} > {atol}")
    return gemm_err[9], gemm_err[5], fb_err


def fb_case_shape(kw: dict) -> tuple[int, int]:
    """(M, N) of a mode's own phase-4 case."""
    if kw.get("pool") in ("max", "avg"):
        return 16 * kw["img_hw"] ** 2, 512 if kw["pool"] == "avg" else 64
    if kw.get("softmax"):
        return 16, 10
    return 16 * 256, 192 if kw.get("norm") else 64


def fb_phase(dev, gen) -> tuple[float, list, int]:
    """Phase 4: fb_epilogue in every mode against its plain version, to
    the tolerances of ``FB_CASES``, at each mode's own (M, N) and at the
    widths of ``FB_WIDTHS`` (and ``FB_ROW_WIDTHS`` for the row modes).
    Returns (max error, per-mode report, cases)."""
    import torch
    from repro_torch.kernels import fb_epilogue, fb_epilogue_ref
    worst, parts, n = 0.0, [], 0
    for mode, kw, with_res, atol, why in FB_CASES:
        M, N0 = fb_case_shape(kw)
        rows_mode = bool(kw.get("norm") or kw.get("softmax")
                         or kw.get("pool") == "seqmean")
        widths = [N0] + [N for N in FB_WIDTHS + (FB_ROW_WIDTHS if rows_mode
                                                  else ()) if N != N0]
        mode_err = 0.0
        for N in widths:
            y = torch.randint(-2 ** 20, 2 ** 20, (M, N), generator=gen,
                              device=dev, dtype=torch.int32)
            scale = torch.full((1, 1), 3.1e-6, device=dev)
            bias = torch.randn(N, generator=gen, device=dev)
            res = torch.randn(M, N, generator=gen, device=dev) if with_res \
                else None
            kwn = dict(kw)
            if kw.get("norm"):
                kwn.update(gamma=torch.randn(N, generator=gen, device=dev),
                           beta=torch.randn(N, generator=gen, device=dev))
            out = fb_epilogue(y, scale, bias, res, **kwn)
            ref = fb_epilogue_ref(y, scale, bias, res, **kwn)
            err = (out - ref).abs().max().item()
            check(out.shape == ref.shape and err <= atol,
                  f"fb_epilogue {mode} M={M} N={N}: max |kernel - plain| "
                  f"{err} > {atol} ({why})")
            if atol == 0.0:
                check(torch.equal(out, ref), f"fb_epilogue {mode} M={M} "
                      f"N={N} is not equal to the plain version")
            mode_err = max(mode_err, err)
            n += 1
        worst = max(worst, mode_err)
        parts.append(f"{mode} {mode_err:.2e}")
    return worst, parts, n


FLASH_CASES = [
    # (B, S, H, hd), causal, window, dtype name, tolerance
    ((1, 128, 1, 64), True, 0, "float32", 1e-4),
    ((1, 128, 1, 64), False, 0, "float32", 1e-4),
    ((2, 256, 4, 64), True, 0, "float32", 1e-4),
    ((2, 256, 4, 64), False, 0, "float32", 1e-4),
    ((1, 512, 2, 64), True, 128, "float32", 1e-4),
    ((16, 64, 3, 64), False, 0, "float32", 1e-4),          # vit_tiny
    ((1, 16, 4, 16), False, 0, "float32", 1e-4),           # attention path
    ((1, 64, 4, 16), False, 0, "float32", 1e-4),
    ((1, 256, 4, 16), False, 0, "float32", 1e-4),
    ((1, 256, 2, 64), True, 0, "bfloat16", 2e-2),
    # every head-dim instantiation (16, 32, 64, 128)
    ((1, 128, 2, 16), True, 0, "float32", 1e-4),
    ((2, 128, 2, 32), False, 0, "float32", 1e-4),
    ((1, 256, 2, 128), True, 0, "float32", 1e-4),
    ((1, 256, 2, 128), False, 0, "float32", 1e-4),
    ((1, 256, 2, 16), False, 0, "bfloat16", 2e-2),
    ((1, 128, 2, 32), True, 0, "bfloat16", 2e-2),
    ((1, 256, 2, 128), False, 0, "bfloat16", 2e-2),
    # ragged: a last key tile of 32 (split 2), head dims below the
    # instantiation, rows that are not 16-byte aligned (synchronous loads)
    ((1, 96, 2, 64), False, 0, "float32", 1e-4),
    ((1, 64, 2, 20), False, 0, "float32", 1e-4),
    ((1, 64, 2, 18), True, 0, "float32", 1e-4),
    ((1, 128, 1, 20), True, 0, "bfloat16", 2e-2),
    # both sides of the key-split threshold: 32 blocks (split 8), 512
    # blocks (no split); bf16 at the kernel bench's shape
    ((1, 512, 4, 64), False, 0, "float32", 1e-4),
    ((1, 512, 4, 64), True, 0, "float32", 1e-4),
    ((8, 512, 8, 64), False, 0, "float32", 1e-4),
    ((1, 512, 4, 64), False, 0, "bfloat16", 2e-2),
    ((1, 512, 4, 64), True, 0, "bfloat16", 2e-2),
]


def flash_phase(dev, gen) -> tuple[float, str]:
    """Phase 9: flash_attention's kernel against its plain version, the
    key split forced on and off, run to run, and against the split's
    plain version.  Returns (max float32 error, report)."""
    import torch
    from repro_torch.kernels import flash_attention, flash_attention_ref, ops
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    worst = 0.0
    splits = {}

    def close(got, ref, tol, what):
        d = (got.float() - ref.float()).abs()
        check(bool((d <= tol + tol * ref.float().abs()).all()),
              f"{what}: max |kernel - plain| {d.max().item()} beyond {tol} "
              f"+ {tol}|ref|")
        return d.max().item()

    for shape, causal, window, dt, tol in FLASH_CASES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        got = flash_attention(q, k, v, causal=causal, window=window)
        check(got.dtype == dtype, f"flash_attention {shape} returns "
              f"{got.dtype}")
        ref = flash_attention_ref(q, k, v, causal=causal, window=window)
        what = f"flash_attention {shape} causal={causal} window={window} {dt}"
        err = close(got, ref, tol, what)
        if dt == "float32":
            worst = max(worst, err)
        sp = fa.key_splits(shape[0], shape[2], shape[1], shape[1], shape[3])
        splits[shape] = sp
        detail(f"{what}: split {sp}, max |kernel - plain| {err:.2e}")
    # one shape below the threshold: the split forced off and on, two runs
    # of the split identical, and the merged output against the split's
    # plain version
    shape = (1, 512, 4, 64)
    q, k, v = (torch.randn(shape, generator=gen, device=dev)
               for _ in range(3))
    auto = fa.key_splits(1, 4, 512, 512, 64)
    check(auto > 1, f"no key split at {shape}")
    for causal in (False, True):
        ref = flash_attention_ref(q, k, v, causal=causal)
        runs = {sp: fa._launch(q, k, v, causal=causal, window=0, splits=sp)
                for sp in (1, 2, auto)}
        again = fa._launch(q, k, v, causal=causal, window=0, splits=auto)
        check(torch.equal(runs[auto], again), f"flash_attention {shape} "
              f"causal={causal} split {auto}: two runs differ")
        for sp, got in runs.items():
            worst = max(worst, close(got, ref, 1e-4, f"flash_attention "
                                     f"{shape} causal={causal} split {sp}"))
            split_ref = fa.flash_attention_split_ref(q, k, v, causal=causal,
                                                     splits=sp)
            close(got, split_ref, 1e-4, f"flash_attention {shape} causal="
                  f"{causal} split {sp} against the split's plain version")
    q = torch.randn(1, 256, 8, 64, generator=gen, device=dev)
    k, v = (torch.randn(1, 256, 2, 64, generator=gen, device=dev)
            for _ in range(2))
    got = ops.attention(q, k, v, causal=True)
    ref = flash_attention_ref(q, k.repeat_interleave(4, 2),
                              v.repeat_interleave(4, 2), causal=True)
    worst = max(worst, close(got, ref, 1e-4, "ops.attention GQA"))
    n_split = sum(sp > 1 for sp in splits.values())
    report = (f"{len(FLASH_CASES)} shapes (head dims 16/32/64/128, ragged, "
              f"unaligned; {n_split} with a key split) and GQA within "
              f"tolerance; {shape} split 1/2/{auto}, causal and not, within "
              f"1e-4 of the plain version and of the split's, split "
              f"{auto} identical over two runs")
    return worst, report


FUSED_SHAPES = [(128, 256, 128), (256, 512, 384), (128, 1024, 256),
                (256, 512, 256)]
# shapes no 64x64 tile divides, rows that are not 16-byte aligned (the
# synchronous loads), odd N (scalar stores), split and unsplit
FUSED_RAGGED = [(1, 7, 3), (77, 1001, 19), (130, 514, 258)]


def fused_phase(dev, gen) -> tuple[float, str]:
    """Phase 10: fused_gemm_epilogue's kernel against its plain version
    at ``FUSED_SHAPES`` and ``FUSED_RAGGED``, every activation, with and
    without residual, float32 (1e-4) and bfloat16 (2e-2); at 256x512x256
    the K split forced off and left on, two runs of the split
    ``torch.equal``.  Returns (max float32 error, report)."""
    import torch
    from repro_torch.kernels import (fused_gemm_epilogue,
                                     fused_gemm_epilogue_ref)
    module = importlib.import_module("repro_torch.kernels.fused_gemm_epilogue")
    worst = 0.0

    def held(got, ref, dtype, tol, what):
        d = (got.float() - ref.float()).abs()
        ok = bool((d <= tol + tol * ref.float().abs()).all())
        check(got.dtype == dtype and got.shape == ref.shape and ok,
              f"fused_gemm_epilogue {what} {dtype}: max err "
              f"{d.max().item() if d.numel() else 0.0}")
        return d.max().item() if d.numel() else 0.0

    for M, K, N in FUSED_SHAPES + FUSED_RAGGED:
        x = torch.randn(M, K, generator=gen, device=dev)
        w = torch.randn(K, N, generator=gen, device=dev) * 0.05
        b = torch.randn(N, generator=gen, device=dev)
        r = torch.randn(M, N, generator=gen, device=dev)
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            xd, wd = x.to(dtype), w.to(dtype)
            for act in ("none", "relu", "silu", "gelu"):
                for res in (None, r):
                    got = fused_gemm_epilogue(xd, wd, b, res, act=act)
                    ref = fused_gemm_epilogue_ref(xd, wd, b, act=act,
                                                  residual=res)
                    err = held(got, ref, dtype, tol, f"{M}x{K}x{N} {act} "
                               f"res={res is not None}")
                    if dtype == torch.float32:
                        worst = max(worst, err)
    splits = []
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        x = torch.randn(256, 512, generator=gen, device=dev).to(dtype)
        w = (torch.randn(512, 256, generator=gen, device=dev) * .05).to(dtype)
        b = torch.randn(256, generator=gen, device=dev)
        r = torch.randn(256, 256, generator=gen, device=dev)
        auto = module.k_splits(256, 256, 512, x.element_size())[0]
        check(auto > 1, f"no K split at 256x512x256 {dtype}")
        ref = fused_gemm_epilogue_ref(x, w, b, act="silu", residual=r)
        for forced in (1, None):
            got = module._launch(x, w, b, r, "silu", splits=forced)
            err = held(got, ref, dtype, tol, f"256x512x256 split "
                       f"{'auto' if forced is None else forced}")
            if dtype == torch.float32:
                worst = max(worst, err)
        first = module._launch(x, w, b, r, "silu")
        again = module._launch(x, w, b, r, "silu")
        check(torch.equal(first, again), f"fused_gemm_epilogue split "
              f"{auto} {dtype}: two runs differ")
        splits.append(f"{str(dtype).split('.')[-1]} {auto}")
    n = (len(FUSED_SHAPES) + len(FUSED_RAGGED)) * 2 * 4 * 2
    return worst, (f"{n} cases ({len(FUSED_SHAPES)} shapes and ragged "
                   f"{', '.join('x'.join(map(str, t)) for t in FUSED_RAGGED)}"
                   f" x 4 activations x residual x float32/bfloat16) within "
                   f"tolerance; 256x512x256 K split ({', '.join(splits)}) "
                   "and unsplit within tolerance, two split runs torch.equal")


def packed_phase(dev, gen) -> tuple[float, str]:
    """Phase 11: packed_gemm's kernel against its plain version, and the
    grouped wrapper against the ``ref.py`` oracle, for the group sizes of
    ``tests/test_kernels.py`` (the second is the kernel bench's case),
    K=128, N=256, float32 (1e-4) and bfloat16 (2e-2); then block_m
    32/64/96 with a tile map that is not sorted.  Returns (max float32
    error, report)."""
    import torch
    from repro_torch.kernels import (ops, packed_gemm, packed_gemm_ref,
                                     packed_gemm_tiles_ref, pad_groups,
                                     tile_group_map)
    worst, n = 0.0, 0

    def held(a, b, tol, what):
        d = (a.float() - b.float()).abs()
        check(bool((d <= tol + tol * b.float().abs()).all()),
              f"packed_gemm {what}: max err {d.max().item()}")
        return d.max().item()

    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        for sizes in GROUP_SIZES:
            w = (torch.randn(len(sizes), 128, 256, generator=gen,
                             device=dev) * .1).to(dtype)
            x = torch.randn(sum(sizes), 128, generator=gen, device=dev
                            ).to(dtype)
            xp, padded, _, _ = pad_groups(x, sizes, 128)
            tiles = tile_group_map(padded, 128, xp.shape[0] // 128)
            got = packed_gemm(xp, w, tiles)
            check(got.dtype == dtype, f"packed_gemm returned {got.dtype}")
            for a, b in ((got, packed_gemm_tiles_ref(xp, w, tiles, 128)),
                         (ops.grouped_gemm(x, w, sizes),
                          packed_gemm_ref(x, w, sizes))):
                err = held(a, b, tol, f"{sizes} {dtype}")
                if dtype == torch.float32:
                    worst = max(worst, err)
                n += 1
        tiles = torch.tensor([2, 0, 2, 1], dtype=torch.int32)
        for block_m in (32, 64, 96):
            w = (torch.randn(3, 128, 256, generator=gen, device=dev) * .1
                 ).to(dtype)
            x = torch.randn(4 * block_m, 128, generator=gen, device=dev
                            ).to(dtype)
            got = packed_gemm(x, w, tiles, block_m=block_m)
            err = held(got, packed_gemm_tiles_ref(x, w, tiles, block_m), tol,
                       f"block_m {block_m} map [2, 0, 2, 1] {dtype}")
            if dtype == torch.float32:
                worst = max(worst, err)
            n += 1
    return worst, (f"{n} cases: {len(GROUP_SIZES)} group-size lists, kernel "
                   "and grouped_gemm, and block_m 32/64/96 with the map "
                   "[2, 0, 2, 1], float32 within 1e-4 and bfloat16 within "
                   "2e-2")


# vit_tiny on the card against the CPU plain path.  Not bit-exact: the
# gelu, layer-norm and softmax epilogues differ from their plain versions
# by ulps (FB_CASES), and a flipped int8 value in the next quantization
# carries on.  The limits sit above what that gives (1.31e-3 relative
# logits at batches 1-16, seed 0) and at or below what the CPU tests hold
# the port to against JAX (2e-2 relative logits, 1e-3 probabilities).
VIT_REL = 1e-2
VIT_PROB_ATOL = 1e-3


def vit_phase(vit_dev, vit_cpu, rng) -> dict:
    """Phase 12: vit_tiny serving batches 1, 3, 16 (probs and logits),
    the launch counts read just after, against the CPU plain path."""
    import torch
    from repro_torch.kernels import crossbar_gemm, fb_epilogue
    execute = importlib.import_module("repro_torch.program.execute")
    stages = vit_dev.program.stages()
    n_dyn = sum(g.kind == "dyn_gemm" for g, _ in stages)
    requests = [rng.standard_normal((b, 32, 32, 3)).astype("float32")
                for b in (1, 3, 16)]
    per_dyn = []
    dyn_stage = execute._dyn_stage

    def counted(*args, **kw):
        before = crossbar_gemm.launches, fb_epilogue.launches
        out = dyn_stage(*args, **kw)
        per_dyn.append((crossbar_gemm.launches - before[0],
                        fb_epilogue.launches - before[1]))
        return out

    execute._dyn_stage = counted
    try:
        torch.cuda.synchronize()
        crossbar_gemm.launches = fb_epilogue.launches = 0
        served = [(vit_dev.run(x), vit_dev.run(x, logits=True))
                  for x in requests]
        torch.cuda.synchronize()
        launches = {"crossbar_gemm": crossbar_gemm.launches,
                    "fb_epilogue": fb_epilogue.launches}
    finally:
        execute._dyn_stage = dyn_stage
    runs = 2 * len(requests)
    want = len(stages) * runs
    check(launches == {"crossbar_gemm": want, "fb_epilogue": want},
          f"vit_tiny launch counts {launches}, expected {want} each")
    check(len(per_dyn) == n_dyn * runs and all(d == (1, 1) for d in per_dyn),
        f"vit_tiny dynamic stages launched {per_dyn}, expected one "
        "crossbar_gemm and one fb_epilogue each")
    agree, worst_rel, worst_prob = [], 0.0, 0.0
    for x, (probs, logits) in zip(requests, served):
        ref = vit_cpu.run(x, logits=True)
        got, probs = logits.cpu(), probs.cpu()
        check(got.shape == (len(x), 10) and bool(torch.isfinite(got).all())
              and bool(torch.isfinite(probs).all()), "vit_tiny non-finite")
        check(bool(torch.allclose(probs.sum(1), torch.ones(len(x)),
                                  atol=1e-5)), "probabilities do not sum to 1")
        worst_rel = max(worst_rel, ((got - ref).abs().max()
                                    / ref.abs().max()).item())
        worst_prob = max(worst_prob,
                         (probs - vit_cpu.run(x)).abs().max().item())
        agree.append((got.argmax(1) == ref.argmax(1)).float().mean().item())
    check(min(agree) == 1.0, f"vit_tiny GPU vs CPU argmax agreement {agree}")
    check(worst_rel <= VIT_REL, f"vit_tiny GPU vs CPU relative logit error "
          f"{worst_rel:.2e} > {VIT_REL}")
    check(worst_prob <= VIT_PROB_ATOL, f"vit_tiny GPU vs CPU probabilities "
          f"differ by {worst_prob:.2e} > {VIT_PROB_ATOL}")
    return dict(launches=launches, n_dyn=n_dyn, n_stages=len(stages),
                agree=min(agree), rel=worst_rel, prob=worst_prob,
                dyn_runs=len(per_dyn))


# phase 12's further input draws of vit_tiny at batch 16 (seeds of
# numpy's default_rng), beside seed 0's requests
VIT_DRAWS = (1, 2, 3)


def fb_atol(kw: dict) -> float:
    """The ``FB_CASES`` tolerance of an epilogue call: the largest of its
    modes' (0: bit for bit)."""
    tol = 0.0
    if kw.get("act") == "gelu":
        tol = max(tol, 1e-6)
    if kw.get("softmax"):
        tol = max(tol, 1e-6)
    if kw.get("norm", "none") != "none" or kw.get("pool") == "seqmean":
        tol = max(tol, 1e-5)
    return tol


def record_stages(model, x) -> tuple:
    """``model.run(x, logits=True)`` with, per stage, the buffers the
    stage read, its ``crossbar_gemm`` operands and int32 output and its
    ``fb_epilogue`` output and keyword arguments.  Returns (logits,
    records)."""
    execute = importlib.import_module("repro_torch.program.execute")
    saved = (execute._static_stage, execute._dyn_stage,
             execute.crossbar_gemm, execute.fb_epilogue)
    recs: list[dict] = []

    def gemm(x8, w8, **kw):
        y = saved[2](x8, w8, **kw)
        recs[-1]["gemm"] = (x8, w8, y)
        return y

    def fb(y, *args, **kw):
        out = saved[3](y, *args, **kw)
        recs[-1]["fb"] = (out, kw)
        return out

    def static(*args, **kw):
        recs.append(dict(bufs=dict(args[3]), kw=kw))
        return saved[0](*args, **kw)

    def dyn(*args):
        recs.append(dict(bufs=dict(args[2]), kw={}))
        return saved[1](*args)

    (execute._static_stage, execute._dyn_stage, execute.crossbar_gemm,
     execute.fb_epilogue) = static, dyn, gemm, fb
    try:
        logits = model.run(x, logits=True)
    finally:
        (execute._static_stage, execute._dyn_stage, execute.crossbar_gemm,
         execute.fb_epilogue) = saved
    return logits, recs


def teacher_forced(vit_dev, recs) -> list[dict]:
    """Each stage of ``vit_dev`` run on the card from the CPU path's own
    input buffers (``recs`` from ``record_stages`` on the CPU model):
    its int32 GEMM output against the CPU's (``torch.equal``) and its FB
    output against the CPU's, to the ``FB_CASES`` tolerance of its modes."""
    import torch
    execute = importlib.import_module("repro_torch.program.execute")
    saved = execute.crossbar_gemm, execute.fb_epilogue
    got: dict = {}

    def gemm(x8, w8, **kw):
        got["y"] = saved[0](x8, w8, **kw)
        return got["y"]

    def fb(y, *args, **kw):
        got["fb"] = saved[1](y, *args, **kw)
        return got["fb"]

    out = []
    cfg = vit_dev.program.cfg
    stages = zip(vit_dev.program.stages(), vit_dev.packed.stages, recs)
    execute.crossbar_gemm, execute.fb_epilogue = gemm, fb
    try:
        for (op, posts), st, rec in stages:
            bufs = {k: v.to(vit_dev.device) for k, v in rec["bufs"].items()}
            if op.kind == "dyn_gemm":
                execute._dyn_stage(op, posts, bufs, cfg)
            else:
                execute._static_stage(op, posts, st, bufs, cfg, **rec["kw"])
            ref_fb, kw = rec["fb"]
            err = (got["fb"].cpu() - ref_fb).abs().max().item()
            out.append(dict(name=op.name, gemm_equal=torch.equal(
                got["y"].cpu(), rec["gemm"][2]), fb_err=err,
                fb_atol=fb_atol(kw)))
    finally:
        execute.crossbar_gemm, execute.fb_epilogue = saved
    return out


def vit_draws_phase(vit_dev, vit_cpu) -> dict:
    """Phase 12, continued: vit_tiny at batch 16 on the ``VIT_DRAWS``
    inputs, each draw's max relative logit gap to the CPU path and argmax
    agreement (printed, not held: the gap depends on the draw); then on
    the draw with the largest gap, every stage teacher-forced from the
    CPU path's buffers (int32 GEMM outputs ``torch.equal``, FB outputs
    within ``FB_CASES``' tolerances, both held), and, in the free-running
    GPU forward, the int8 GEMM operands that differ from the CPU path's,
    stage by stage."""
    import numpy as np
    import torch
    draws = []
    for seed in VIT_DRAWS:
        x = np.random.default_rng(seed).standard_normal(
            (16, 32, 32, 3)).astype(np.float32)
        got = vit_dev.run(x, logits=True).cpu()
        ref = vit_cpu.run(x, logits=True)
        check(bool(torch.isfinite(got).all()), "vit_tiny non-finite logits")
        draws.append(dict(seed=seed, x=x, rel=((got - ref).abs().max()
                                               / ref.abs().max()).item(),
                          agree=(got.argmax(1) == ref.argmax(1)).float()
                          .mean().item()))
    worst = max(draws, key=lambda d: d["rel"])
    _, cpu_recs = record_stages(vit_cpu, worst["x"])
    forced = teacher_forced(vit_dev, cpu_recs)
    for f in forced:
        check(f["gemm_equal"], f"vit_tiny teacher-forced stage {f['name']}: "
              "the int32 GEMM output differs from the CPU path's")
        check(f["fb_err"] <= f["fb_atol"], f"vit_tiny teacher-forced stage "
              f"{f['name']}: FB output off by {f['fb_err']:.2e} > "
              f"{f['fb_atol']}")
    _, gpu_recs = record_stages(vit_dev, worst["x"])
    flips = []
    for op_rec, cpu_rec, f in zip(gpu_recs, cpu_recs, forced):
        n = sum(int((a.cpu() != b).sum()) for a, b in
                zip(op_rec["gemm"][:2], cpu_rec["gemm"][:2])
                if a.dtype == torch.int8)
        flips.append((f["name"], n, (op_rec["fb"][0].cpu()
                                     - cpu_rec["fb"][0]).abs().max().item()))
    for name, n, d in flips:
        detail(f"vit_tiny draw {worst['seed']} free run, stage {name}: "
               f"{n} int8 GEMM operands differ from the CPU path's, FB "
               f"output max |GPU - CPU| {d:.2e}")
    return dict(draws=draws, worst=worst["seed"], forced=forced,
                flips=flips)


def attention_graph(api):
    """The attention bench's geometry: one attention(4) layer, dim 64."""
    nb = api.NetworkBuilder("attn_prefill", input_seq_dim=64)
    nb.attention(4, name="attn")
    return nb.build()


def attention_phase(model, dev, gen) -> tuple[dict, list]:
    """Phase 13: crossbar attention through ``run`` against
    ``ops.attention`` on the same projected q/k/v (non-causal), then the
    same output projection.  Returns the flash launch count of the
    driven calls and, per T, (x, q, k, v, rel, corr)."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention, ops
    from repro_torch.program.sequence import split_qkv_heads
    p = model.params["attn"]
    cases = []
    flash_attention.launches = 0
    for T in ATTN_T:
        x = torch.randn(1, T, 64, generator=gen, device=dev)
        y_cb = model.run(x)
        qkv = (x.reshape(-1, 64) @ p["wqkv"] + p["bqkv"]).reshape(1, T, -1)
        q, k, v = (u.reshape(1, 4, T, 16).transpose(1, 2).contiguous()
                   for u in split_qkv_heads(qkv, 4))
        ctx = ops.attention(q, k, v, causal=False)
        y_fl = ctx.reshape(1, T, 64) @ p["wo"] + p["bo"]
        a, b = y_cb.cpu().numpy().ravel(), y_fl.cpu().numpy().ravel()
        rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        corr = float(np.corrcoef(a, b)[0, 1])
        check(rel < 0.12 and corr > 0.99, f"crossbar attention T={T} vs "
              f"flash_attention: rel {rel}, corr {corr}")
        cases.append((T, x, q, k, v, rel, corr))
    check(flash_attention.launches == len(ATTN_T),
          f"attention path: flash_attention launched "
          f"{flash_attention.launches} times, expected {len(ATTN_T)}")
    return {"flash_attention": flash_attention.launches}, cases


def ops_phase(dev, gen) -> dict:
    """Phase 14: ``kernels.ops``' five wrappers at the kernel bench's
    shapes; each launches its kernel once and agrees with its plain
    version.  Returns the launch counts read just after."""
    import torch
    from repro_torch.kernels import (crossbar_gemm, crossbar_gemm_ref,
                                     fb_epilogue, fb_epilogue_ref,
                                     flash_attention, flash_attention_ref,
                                     fused_gemm_epilogue,
                                     fused_gemm_epilogue_ref, ops,
                                     packed_gemm, packed_gemm_ref)
    x8 = torch.randint(-128, 128, (128, 512), generator=gen, device=dev,
                       dtype=torch.int8)
    w8 = torch.randint(-128, 128, (512, 256), generator=gen, device=dev,
                       dtype=torch.int8)
    q, k, v = (torch.randn(1, 512, 4, 64, generator=gen, device=dev)
               for _ in range(3))
    xf = torch.randn(256, 512, generator=gen, device=dev)
    wf = torch.randn(512, 256, generator=gen, device=dev) * 0.05
    bf = torch.zeros(256, device=dev)
    sizes = GROUP_SIZES[1]
    wg = torch.randn(4, 128, 256, generator=gen, device=dev) * 0.1
    xg = torch.randn(sum(sizes), 128, generator=gen, device=dev)
    scale = torch.full((1, 1), 2.5e-5, device=dev)
    kernels = (crossbar_gemm, fb_epilogue, flash_attention,
               fused_gemm_epilogue, packed_gemm)
    torch.cuda.synchronize()
    for kern in kernels:
        kern.launches = 0
    y = ops.crossbar_matmul_int8(x8, w8, rows=256)
    post = ops.fb_postops(y, scale, bf, act="relu")
    att = ops.attention(q, k, v)
    lin = ops.linear_fused(xf, wf, bf, act="silu")
    grp = ops.grouped_gemm(xg, wg, sizes)
    torch.cuda.synchronize()
    launches = {kern.__name__: kern.launches for kern in kernels}
    check(all(n == 1 for n in launches.values()),
          f"ops entry point launches {launches}, expected 1 each")
    check(torch.equal(y, crossbar_gemm_ref(x8, w8, rows=256)),
          "ops.crossbar_matmul_int8 differs")
    check(torch.equal(post, fb_epilogue_ref(y, scale, bf, act="relu")),
          "ops.fb_postops differs")
    for name, got, ref in (
            ("attention", att, flash_attention_ref(q, k, v)),
            ("linear_fused", lin, fused_gemm_epilogue_ref(xf, wf, bf)),
            ("grouped_gemm", grp, packed_gemm_ref(xg, wg, sizes))):
        d = (got - ref).abs()
        check(bool((d <= 1e-4 + 1e-4 * ref.abs()).all()),
              f"ops.{name}: max |kernel - plain| {d.max().item()}")
    return launches


def kernel_times(label: str) -> int:
    """``--kernel-times``: the times of phases 7 and 15 that compare the
    redesigned kernels with another tree, for the ``repro_torch`` on
    ``sys.path``: ``fb_epilogue`` per ResNet-18 b16 forward and at
    vit_tiny's dynamic pairs, ``flash_attention`` on the attention path
    and at ``FLASH_TIMED`` beside SDPA, and ``fused_gemm_epilogue`` and
    ``packed_gemm`` at ``FUSED_TIMED`` / ``PACKED_TIMED``
    (``float_gemm_times``).  The last line is a JSON record."""
    import torch
    import repro_torch
    from repro_torch import api
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    log(nvidia_smi())
    names = ("fb_epilogue", "flash_attention", "fused_gemm_epilogue",
             "packed_gemm")
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.build, names))
    log(f"[times {label}] repro_torch from "
        f"{os.path.dirname(os.path.dirname(repro_torch.__file__))}")
    resnet = api.compile("resnet18", api.HurryConfig(), seed=0,
                         device="cuda")
    f = fb_stage_times(stage_shapes(resnet, 16), dev, gen)
    dyn = dyn_fb_times(dev, gen)
    flt = flash_times(dev, gen)
    fg = float_gemm_times(dev, gen)
    rec = dict(label=label, fb_resnet18_b16=dict(
        ms=f["ms"], bound_ms=f["bound"], plain_ms=f["plain"],
        launches=len(f["stages"])),
        fb_vit_dyn_pair=dict(ms=dyn["ms"], bound_ms=dyn["bound"],
                             plain_ms=dyn["plain"]),
        flash_attention_path=dict(ms=flt["path"]["ms"],
                                  sdpa_ms=flt["path"]["lib"],
                                  plain_ms=flt["path"]["plain"]),
        flash_attention=flt["shapes"], fused_gemm_epilogue=fg["fused"],
        packed_gemm=fg["packed"])
    fu, pk = fg["fused"][0], fg["packed"][0]
    log(f"[times {label}] fb_epilogue ResNet-18 b16 {f['ms']:.4f} ms (bound "
        f"{f['bound']:.4f}); vit_tiny dynamic pair {dyn['ms']:.4f} ms; "
        f"flash_attention path {flt['path']['ms']:.4f} ms; "
        f"fused_gemm_epilogue 256x512x256 silu float32 {fu['ms']:.4f} ms; "
        f"packed_gemm 4 groups float32 {pk['ms']:.4f} ms")
    print(json.dumps(rec))
    return 0


def main(argv: list[str] | None = None) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernel-times", action="store_true",
                        help="only time the redesigned kernels "
                        "(see kernel_times)")
    parser.add_argument("--src", help="import repro_torch from this "
                        "directory instead of src/ beside the script")
    parser.add_argument("--label", default="tree")
    args = parser.parse_args(argv)
    if args.src:
        sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if args.kernel_times:
        return kernel_times(args.label)
    import numpy as np
    from repro_torch import api
    from repro_torch.kernels import _build
    from repro_torch.kernels.crossbar_gemm import (clip_possible,
                                                   crossbar_gemm,
                                                   crossbar_gemm_exact_ref,
                                                   crossbar_gemm_ref,
                                                   kernel_layout)
    from repro_torch.kernels.fb_epilogue import fb_epilogue

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    # -- 1. device + build ------------------------------------------------
    card = nvidia_smi()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.SOURCES)) as pool:
        list(pool.map(_build.build, _build.SOURCES))
    build_s = time.perf_counter() - t0
    log(card)
    log(f"[1 device] {torch.cuda.get_device_name(0)} | torch "
        f"{torch.__version__} cuda {torch.version.cuda} | kernels built in "
        f"{build_s:.1f} s")
    for name in _build.SOURCES:
        with open(f"{_build.library_path(name)}.log") as f:
            for ln in f:
                if "registers" in ln or "spill" in ln:
                    detail(f"ptxas {name}: {ln.strip()}")
    sass = sass_opcodes(_build, "crossbar_gemm")
    check(sass is None or (sass["IGMMA"] > 0 and sass["IDP4A"] == 0
                           and sass["POPC"] == 0),
          f"crossbar_gemm's SASS is not on the int8 tensor cores: {sass}")
    # the float GEMMs' products on the tensor cores (mma.sync: HMMA; a
    # wgmma design would show HGMMA)
    float_sass = {name: sass_opcodes(_build, name)
                  for name in ("fused_gemm_epilogue", "packed_gemm")}
    for name, ops_ in float_sass.items():
        check(ops_ is None or ops_["HMMA"] + ops_["HGMMA"] > 0,
              f"{name}'s SASS holds no tensor-core instruction: {ops_}")
    log(f"[1 sass] crossbar_gemm opcodes "
        f"{sass if sass else 'not read (no cuobjdump)'}; "
        + "; ".join(f"{name} {ops_ if ops_ else 'not read'}"
                    for name, ops_ in float_sass.items()))

    def rand_i8(*shape):
        return torch.randint(-128, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    # shapes of the main path: ResNet-18, default config, batch 16
    resnet_gpu = api.compile("resnet18", api.HurryConfig(), seed=0,
                             device="cuda")
    shapes = stage_shapes(resnet_gpu, 16)

    # -- 2. crossbar_gemm, exact branch ----------------------------------
    gemm_err, n_exact, ex_splits = gemm_exact_phase(dev, gen, shapes)
    torch.cuda.synchronize()
    log(f"[2 crossbar_gemm exact] {n_exact} cases equal to the plain version "
        f"(torch.equal): ResNet-18 b16 stages through the mounted wt, ragged "
        f"and edge shapes (M 1/4/16 x K {'/'.join(map(str, EDGE_K))} x N "
        f"{'/'.join(map(str, EDGE_N))}), all -128, K split {ex_splits} and 1")

    # -- 3. crossbar_gemm, sliced branch ---------------------------------
    sliced_err, n_sliced, clipped, sl_splits = gemm_sliced_phase(dev, gen)
    torch.cuda.synchronize()
    log(f"[3 crossbar_gemm sliced] {n_sliced} cases equal to the plain "
        f"version, ADC clips fired in {clipped} (every case where rows > "
        f"2^adc_bits - 1); rows {'/'.join(map(str, EDGE_ROWS))} x M 1/4/16, "
        f"all -1, chunk split {sl_splits} and 1")

    # -- 4. fb_epilogue, every mode --------------------------------------
    fb_err, parts, n_fb = fb_phase(dev, gen)
    torch.cuda.synchronize()
    log(f"[4 fb_epilogue] {n_fb} cases (every mode at N "
        f"{'/'.join(map(str, FB_WIDTHS))} and its own width, the row modes "
        f"also at {'/'.join(map(str, FB_ROW_WIDTHS))}); max |kernel - plain| "
        "per mode: " + ", ".join(parts))

    # -- 5. the main path: ResNet-18 serving requests --------------------
    resnet_cpu = api.compile("resnet18", api.HurryConfig(), seed=0,
                             device="cpu")
    n_stages = len(resnet_gpu.program.stages())
    rng = np.random.default_rng(0)
    requests = [rng.standard_normal((b, 32, 32, 3)).astype(np.float32)
                for b in (1, 3, 16)]
    torch.cuda.synchronize()
    crossbar_gemm.launches = fb_epilogue.launches = 0
    served = [(resnet_gpu.run(x), resnet_gpu.run(x, logits=True))
              for x in requests]
    torch.cuda.synchronize()
    main_launches = {"crossbar_gemm": crossbar_gemm.launches,
                     "fb_epilogue": fb_epilogue.launches}
    want = n_stages * 2 * len(requests)
    check(main_launches == {"crossbar_gemm": want, "fb_epilogue": want},
          f"launch counts {main_launches}, expected {want} each "
          f"({n_stages} stages x {2 * len(requests)} runs)")
    worst_rel, agree, exact = 0.0, [], True
    for x, (probs, logits) in zip(requests, served):
        ref_logits = resnet_cpu.run(x, logits=True)
        ref_probs = resnet_cpu.run(x)
        got = logits.cpu()
        check(got.shape == (x.shape[0], 10) and bool(torch.isfinite(got).all())
              and bool(torch.isfinite(probs).all()), "non-finite output")
        check(bool(torch.allclose(probs.sum(1).cpu(), torch.ones(len(x)),
                                  atol=1e-5)), "probabilities do not sum to 1")
        check(bool(torch.allclose(probs.cpu(), ref_probs, atol=1e-6)),
              "probabilities differ from the CPU plain path")
        rel = ((got - ref_logits).abs().max()
               / ref_logits.abs().max()).item()
        worst_rel = max(worst_rel, rel)
        exact &= torch.equal(got, ref_logits)
        agree.append((got.argmax(1) == ref_logits.argmax(1)).float().mean()
                     .item())
    check(min(agree) == 1.0 and worst_rel <= 1e-4,
          f"ResNet-18 GPU vs CPU: argmax agreement {agree}, max rel error "
          f"{worst_rel}")
    log(f"[5 resnet18 main path] batches 1,3,16 x (probs, logits): launches "
        f"{main_launches} = {n_stages} stages each run; vs CPU plain path "
        f"argmax agreement {min(agree)}, max rel logit error {worst_rel:.2e}, "
        f"bit-exact {exact}")

    # -- 6. the sliced branch end to end: AlexNet, 8-bit ADC -------------
    cfg8 = api.HurryConfig(adc_bits=8)
    alex_gpu = api.compile("alexnet", cfg8, seed=0, device="cuda")
    alex_cpu = api.compile("alexnet", cfg8, seed=0, device="cpu")
    sliced_stages = sum(clip_possible(min(g.tile_rows, st.w8.shape[0]), 8)
                        for (g, _), st in zip(alex_gpu.program.stages(),
                                              alex_gpu.packed.stages))
    x4 = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    torch.cuda.synchronize()
    crossbar_gemm.launches = fb_epilogue.launches = 0
    got = alex_gpu.run(x4, logits=True)
    torch.cuda.synchronize()
    sliced_launches = crossbar_gemm.launches
    n_alex = len(alex_gpu.program.stages())
    check(sliced_launches == n_alex and fb_epilogue.launches == n_alex,
          f"AlexNet launches {sliced_launches}/{fb_epilogue.launches}, "
          f"expected {n_alex}")
    ref = alex_cpu.run(x4, logits=True)
    got = got.cpu()
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    a_agree = (got.argmax(1) == ref.argmax(1)).float().mean().item()
    check(bool(torch.isfinite(got).all()) and a_agree == 1.0 and rel <= 1e-4,
          f"AlexNet adc8 GPU vs CPU: agreement {a_agree}, rel {rel}")
    log(f"[6 alexnet adc_bits=8] {sliced_stages} of {n_alex} stages on the "
        f"sliced branch; vs CPU plain path argmax agreement {a_agree}, max "
        f"rel logit error {rel:.2e}, bit-exact {torch.equal(got, ref)}")

    # -- 7. times ---------------------------------------------------------
    # bounds sum per-shape max(bytes, operations); `by` keeps each
    # shape's binding term so the sum can say which one dominates.  The
    # GEMM runs in the main path's form: x laid out by kernel_layout (as
    # the executor quantizes into it) and the stage's mounted wt.
    g = {}
    for b in (16, 1):
        gb = dict(ms=0.0, plain=0.0, row=0.0, kmaj=0.0, stages=[],
                  by={"bytes": 0.0, "operations": 0.0})
        for s in shapes if b == 16 else stage_shapes(resnet_gpu, 1):
            M, K, N, rows = s["M"], s["K"], s["N"], s["rows"]
            x, w, wt = rand_i8(M, K), s["w8"], s["wt"]
            xk = kernel_layout(x, K, rows=rows).contiguous()
            g_ms = device_ms(lambda: crossbar_gemm(xk, w, rows=rows, wt=wt))
            g_plain = device_ms(lambda: crossbar_gemm_exact_ref(x, w))
            lib_row, lib_k = int_mm_ms(x, w)
            b_ms, o_ms = gemm_bound(M, N, K, sliced=False)
            gb["by"]["bytes" if b_ms >= o_ms else "operations"] += max(b_ms,
                                                                      o_ms)
            gb["ms"] += g_ms
            gb["plain"] += g_plain
            gb["row"] += lib_row
            gb["kmaj"] += lib_k
            gb["stages"].append((g_ms - max(b_ms, o_ms), s["name"], g_ms,
                                 max(b_ms, o_ms)))
            line = (f"time b{b} {s['name']}: M={M} K={K} N={N} gemm "
                    f"{g_ms:.4f} ms (bound {max(b_ms, o_ms):.5f}, plain "
                    f"{g_plain:.4f}, _int_mm row-major {lib_row:.4f}, "
                    f"K-major {lib_k:.4f})")
            detail(line)
        for gap, name, ms, bnd in sorted(gb["stages"], reverse=True)[:5]:
            detail(f"top offender b{b} {name}: {ms:.4f} ms, bound {bnd:.5f}"
                   f", gap {gap:.4f} ms")
        g[b] = gb
    f = fb_stage_times(shapes, dev, gen)
    # the AlexNet adc_bits=8 path's GEMMs (batch 4): all but conv1 sliced
    sl = dict(ms=0.0, plain=0.0, by={"bytes": 0.0, "operations": 0.0})
    for s in stage_shapes(alex_gpu, 4):
        M, K, N, rows = s["M"], s["K"], s["N"], s["rows"]
        x, w, wt = rand_i8(M, K), s["w8"], s["wt"]
        xk = kernel_layout(x, K, rows=rows, adc_bits=8).contiguous()
        is_sliced = clip_possible(min(rows, K), 8)
        s_ms = device_ms(lambda: crossbar_gemm(xk, w, adc_bits=8, rows=rows,
                                               wt=wt))
        s_plain = device_ms(
            lambda: crossbar_gemm_ref(x, w, adc_bits=8, rows=rows)
            if is_sliced else crossbar_gemm_exact_ref(x, w), calls=5)
        b_ms, o_ms = gemm_bound(M, N, K, sliced=is_sliced)
        sl["by"]["bytes" if b_ms >= o_ms else "operations"] += max(b_ms, o_ms)
        sl["ms"] += s_ms
        sl["plain"] += s_plain
        detail(
            f"time alexnet-adc8 {s['name']}: M={M} K={K} N={N} "
            f"{'sliced' if is_sliced else 'exact'} {s_ms:.4f} ms (bound "
            f"{max(b_ms, o_ms):.5f}, plain {s_plain:.4f})")
    e2e = {}
    for b in (1, 16):
        xb = torch.randn(b, 32, 32, 3, generator=gen, device=dev)
        e2e[b] = wall_ms(lambda: resnet_gpu.run(xb))

    busy, idle = {}, {}
    for b in (1, 16):
        xb = torch.randn(b, 32, 32, 3, generator=gen, device=dev)
        busy[b], top = forward_profile(lambda: resnet_gpu.run(xb))
        idle[b] = "not measured" if busy[b] is None else \
            f"{1 - busy[b] / e2e[b]:.1%}"
        detail(f"resnet18 b{b} forward: device busy "
               f"{'not measured' if busy[b] is None else f'{busy[b]:.3f} ms'}"
               f" of {e2e[b]:.3f} ms, idle {idle[b]}")
        for ms, n, name in top:
            detail(f"  {name}: {ms:.4f} ms in {n} launches")

    def bound(by: dict) -> tuple[float, str]:
        return sum(by.values()), max(by, key=by.get)

    g_bound, g_by = bound(g[16]["by"])
    g1_bound, g1_by = bound(g[1]["by"])
    s_bound, s_by = bound(sl["by"])
    # the library yardstick: _int_mm on the faster of the two layouts
    lib_layout = "row-major" if g[16]["row"] <= g[16]["kmaj"] else "K-major"
    g_lib = min(g[16]["row"], g[16]["kmaj"])
    log(f"[7 times] per ResNet-18 batch-16 forward: crossbar_gemm "
        f"{g[16]['ms']:.3f} ms (bound {g_bound:.4f} by {g_by}, plain "
        f"{g[16]['plain']:.3f}, torch._int_mm row-major {g[16]['row']:.3f} / "
        f"K-major {g[16]['kmaj']:.3f}, library_ms {lib_layout}); per "
        f"batch-1 forward: crossbar_gemm "
        f"{g[1]['ms']:.3f} ms (bound {g1_bound:.4f} by {g1_by}, plain "
        f"{g[1]['plain']:.3f}, torch._int_mm row-major {g[1]['row']:.3f} / "
        f"K-major {g[1]['kmaj']:.3f}); fb_epilogue b16 "
        f"{f['ms']:.3f} ms (bound {f['bound']:.4f} by bytes, plain "
        f"{f['plain']:.3f}); AlexNet adc8 b4 crossbar_gemm {sl['ms']:.3f} ms "
        f"(bound {s_bound:.4f} by {s_by}, plain {sl['plain']:.3f}); "
        f"resnet18 end to end {e2e[1]:.3f} ms at b=1, {e2e[16]:.3f} ms at "
        f"b=16; device idle {idle[1]} at b=1, {idle[16]} at b=16")

    # -- 8. batched launches at vit_tiny's dynamic shapes ----------------
    b_exact_err, b_sliced_err, b_fb_err = batched_phase(dev, gen)
    gemm_err = max(gemm_err, b_exact_err)
    sliced_err = max(sliced_err, b_sliced_err)
    fb_err = max(fb_err, b_fb_err)
    torch.cuda.synchronize()
    log("[8 batched launches] 48 slices of 64x64x64, one launch each: "
        "crossbar_gemm exact and sliced equal to the plain version and to "
        "the per-slice 2-D calls (torch.equal), 5 ragged slices of "
        "16x1001x19 equal at rows 511/247/494; fb_epilogue dequant equal, "
        "softmax+post_scale max |kernel - plain| "
        f"{b_fb_err:.2e} (limit 1e-6)")

    # -- 9-11. the new kernels against their plain versions --------------
    flash_err, flash_report = flash_phase(dev, gen)
    torch.cuda.synchronize()
    log(f"[9 flash_attention] {flash_report}; max |kernel - plain| float32 "
        f"{flash_err:.2e}")
    fused_err, fused_report = fused_phase(dev, gen)
    torch.cuda.synchronize()
    log(f"[10 fused_gemm_epilogue] {fused_report}; max |kernel - plain| "
        f"float32 {fused_err:.2e}")
    packed_err, packed_report = packed_phase(dev, gen)
    torch.cuda.synchronize()
    log(f"[11 packed_gemm] {packed_report}; max err float32 "
        f"{packed_err:.2e}")

    # -- 12. the sequence path: vit_tiny serving requests ----------------
    vit_gpu = api.compile("vit_tiny", api.HurryConfig(), seed=0,
                          device="cuda")
    vit_cpu = api.compile("vit_tiny", api.HurryConfig(), seed=0,
                          device="cpu")
    vit = vit_phase(vit_gpu, vit_cpu, rng)
    vit_e2e, vit_idle = {}, {}
    for b in (1, 16):
        xb = torch.randn(b, 32, 32, 3, generator=gen, device=dev)
        vit_e2e[b] = wall_ms(lambda: vit_gpu.run(xb))
        busy, top = forward_profile(lambda: vit_gpu.run(xb))
        vit_idle[b] = "not measured" if busy is None else \
            f"{1 - busy / vit_e2e[b]:.1%}"
        detail(f"vit_tiny b{b} forward: device busy "
               f"{'not measured' if busy is None else f'{busy:.3f} ms'}"
               f" of {vit_e2e[b]:.3f} ms, idle {vit_idle[b]}")
        for ms, n, name in top:
            detail(f"  {name}: {ms:.4f} ms in {n} launches")
    log(f"[12 vit_tiny main path] batches 1,3,16 x (probs, logits): launches "
        f"{vit['launches']} = {vit['n_stages']} stages each run, "
        f"{vit['n_dyn']} dynamic stages per run with one crossbar_gemm and "
        f"one fb_epilogue each ({vit['dyn_runs']} dynamic-stage calls); vs "
        f"CPU plain path argmax agreement {vit['agree']}, max rel logit "
        f"error {vit['rel']:.2e} (limit {VIT_REL}), max |probs diff| "
        f"{vit['prob']:.2e} (limit {VIT_PROB_ATOL}); end to end {vit_e2e[1]:.3f} ms at b=1, "
        f"{vit_e2e[16]:.3f} ms at b=16; device idle {vit_idle[1]} at b=1, "
        f"{vit_idle[16]} at b=16")
    vd = vit_draws_phase(vit_gpu, vit_cpu)
    flipped = [(name, n) for name, n, _ in vd["flips"] if n]
    log("[12 vit_tiny draws] batch 16, GPU against the CPU plain path: "
        + "; ".join(f"seed {d['seed']} max rel logit gap {d['rel']:.2e}, "
                    f"argmax agreement {d['agree']:.4f}"
                    for d in vd["draws"])
        + f" (printed, not held). Teacher-forced on seed {vd['worst']}: "
        f"{len(vd['forced'])} stages from the CPU path's buffers, int32 GEMM "
        "outputs torch.equal in all, FB outputs within FB_CASES' tolerances "
        f"(max err {max(f['fb_err'] for f in vd['forced']):.2e}); free run: "
        + (f"int8 operands first differ at stage {flipped[0][0]}, per stage "
           + ", ".join(f"{name} {n}" for name, n in flipped)
           if flipped else "no int8 operand differs"))

    # -- 13. the attention path ------------------------------------------
    from repro_torch.kernels import ops
    attn_model = api.compile(attention_graph(api),
                             api.HurryConfig(array_rows=511), seed=0,
                             buckets=(), device="cuda")
    torch.cuda.synchronize()
    attn_launches, attn_cases = attention_phase(attn_model, dev, gen)
    torch.cuda.synchronize()
    parts = []
    for T, x, q, k, v, rel, corr in attn_cases:
        t_cb = wall_ms(lambda: attn_model.run(x))
        t_fl = wall_ms(lambda: ops.attention(q, k, v, causal=False))
        parts.append(f"T={T}: rel {rel:.3f} corr {corr:.4f}, crossbar "
                     f"{t_cb:.3f} ms, flash {t_fl:.3f} ms")
    log(f"[13 attention path] flash_attention launches {attn_launches}; "
        + "; ".join(parts) + " (host clock + synchronize, median of 10)")

    # -- 14. the ops entry point -----------------------------------------
    ops_launches = ops_phase(dev, gen)
    log(f"[14 kernels.ops] launches {ops_launches}; each within tolerance "
        "of its plain version")

    # -- 15. times of the new kernels ------------------------------------
    # vit_tiny's dynamic stages at batch 16: 48 (batch, head) slices
    S = 16 * 3
    xs, ws = rand_i8(S, 64, 64), rand_i8(S, 64, 64)
    dg_ms = device_ms(lambda: crossbar_gemm(xs, ws, rows=64))
    dg_plain = device_ms(lambda: crossbar_gemm_exact_ref(xs, ws))
    dfb = dyn_fb_times(dev, gen, S)
    df_ms, df_plain, df_bound = dfb["ms"], dfb["plain"], dfb["bound"]
    b_ms, o_ms = (S * t for t in gemm_bound(64, 64, 64, sliced=False))
    dg_bound = max(b_ms, o_ms)
    pairs = vit["n_dyn"] // 2       # (scores, context) stage pairs
    detail(f"time vit_tiny dynamic stages (b16, {S} slices of 64x64x64, "
           f"{vit['n_dyn']} per forward): crossbar_gemm {dg_ms:.4f} ms per "
           f"launch (bound {dg_bound:.5f} by "
           f"{'bytes' if b_ms >= o_ms else 'operations'}, plain "
           f"{dg_plain:.4f}); fb_epilogue scores+context {df_ms:.4f} ms "
           f"(bound {df_bound:.5f} by bytes, plain {df_plain:.4f})")
    # flash_attention over the attention path's shapes (1, T, 4, 16), and
    # at the timed shapes beside SDPA
    flt = flash_times(dev, gen)
    fl = flt["path"]
    flash_vs = "; ".join(
        f"{tuple(t['shape'])}{' causal' if t['causal'] else ''} {t['dtype']} "
        f"{t['ms']:.4f} ms (sdpa {t['sdpa_ms']:.4f}, bound "
        f"{t['bound_ms']:.5f})" for t in flt["shapes"])
    # the float GEMMs at the kernel bench's shapes and a larger one each,
    # float32 and bfloat16; the JSON rows are the bench's float32 calls
    # (fused: SiLU beside addmm, which leaves the activation out; packed:
    # beside the per-group matmul loop)
    fg = float_gemm_times(dev, gen)
    fu, pk = fg["fused"][0], fg["packed"][0]

    def lib_text(lib: dict) -> str:
        return ", ".join(f"{k} {'refused' if v is None else f'{v:.4f}'}"
                         for k, v in lib.items())

    gemm_vs = "; ".join(
        [f"fused_gemm_epilogue {'x'.join(map(str, r['shape']))} {r['act']} "
         f"{r['dtype']} {r['ms']:.4f} ms (bound {r['bound_ms']:.5f} by "
         f"{r['bound_by']}, plain {r['plain_ms']:.4f}, "
         f"{lib_text(r['library_ms'])})" for r in fg["fused"]]
        + [f"packed_gemm {r['groups']} groups {r['rows']}x{r['K']}x{r['N']} "
           f"{r['dtype']} {r['ms']:.4f} ms (bound {r['bound_ms']:.5f} by "
           f"{r['bound_by']}, plain {r['plain_ms']:.4f}, "
           f"{lib_text(r['library_ms'])})" for r in fg["packed"]])
    fl_bound, fl_by = bound(fl["by"])
    log(f"[15 times] vit_tiny b16 dynamic stages per forward: crossbar_gemm "
        f"{pairs * 2 * dg_ms:.4f} ms in {2 * pairs} batched launches (bound "
        f"{pairs * 2 * dg_bound:.5f}, plain {pairs * 2 * dg_plain:.4f}); "
        f"fb_epilogue {pairs * df_ms:.4f} ms (bound {pairs * df_bound:.5f}, "
        f"plain {pairs * df_plain:.4f}); flash_attention over T=16,64,256 "
        f"(1,T,4,16) {fl['ms']:.4f} ms (bound {fl_bound:.5f} by {fl_by}, "
        f"plain {fl['plain']:.4f}, sdpa {fl['lib']:.4f}); {flash_vs}; "
        f"{gemm_vs}")

    kernels = [
        dict(name="crossbar_gemm", route="cuda",
             source="src/repro_torch/kernels/csrc/crossbar_gemm.cu",
             replaces="src/repro/kernels/crossbar_gemm.py:116",
             launches=main_launches["crossbar_gemm"]
             + vit["launches"]["crossbar_gemm"], max_abs_err=gemm_err,
             ms=g[16]["ms"], plain_ms=g[16]["plain"], bound_ms=g_bound,
             bound_by=g_by, library_ms=g_lib),
        dict(name="crossbar_gemm (sliced path)", route="cuda",
             source="src/repro_torch/kernels/csrc/crossbar_gemm.cu",
             replaces="src/repro/kernels/crossbar_gemm.py:77",
             launches=sliced_launches, max_abs_err=sliced_err,
             ms=sl["ms"], plain_ms=sl["plain"], bound_ms=s_bound,
             bound_by=s_by, library_ms=None),
        dict(name="fb_epilogue", route="cuda",
             source="src/repro_torch/kernels/csrc/fb_epilogue.cu",
             replaces="src/repro/kernels/fb_epilogue.py:102",
             launches=main_launches["fb_epilogue"]
             + vit["launches"]["fb_epilogue"], max_abs_err=fb_err,
             ms=f["ms"], plain_ms=f["plain"], bound_ms=f["bound"],
             bound_by="bytes", library_ms=None),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:28",
             launches=attn_launches["flash_attention"], max_abs_err=flash_err,
             ms=fl["ms"], plain_ms=fl["plain"], bound_ms=fl_bound,
             bound_by=fl_by, library_ms=fl["lib"]),
        dict(name="fused_gemm_epilogue", route="cuda",
             source="src/repro_torch/kernels/csrc/fused_gemm_epilogue.cu",
             replaces="src/repro/kernels/fused_gemm_epilogue.py:23",
             launches=ops_launches["fused_gemm_epilogue"],
             max_abs_err=fused_err, ms=fu["ms"], plain_ms=fu["plain_ms"],
             bound_ms=fu["bound_ms"], bound_by=fu["bound_by"],
             library_ms=fu["library_ms"]["addmm"]),
        dict(name="packed_gemm", route="cuda",
             source="src/repro_torch/kernels/csrc/packed_gemm.cu",
             replaces="src/repro/kernels/packed_gemm.py:26",
             launches=ops_launches["packed_gemm"], max_abs_err=packed_err,
             ms=pk["ms"], plain_ms=pk["plain_ms"], bound_ms=pk["bound_ms"],
             bound_by=pk["bound_by"],
             library_ms=pk["library_ms"]["matmul loop"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
