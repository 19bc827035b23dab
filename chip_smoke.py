#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and hold its kernels.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

It needs one CUDA GPU, ``nvcc`` and the repository's ``src/`` beside it,
and exits nonzero (printing no result) without them.  Phases, one line
each on standard output (the per-shape details go to standard error):

1. device: name and power limit (``nvidia-smi``), torch/CUDA versions,
   and the seconds to build both kernels (one ``nvcc`` each, in
   parallel);
2. ``crossbar_gemm`` exact branch at ResNet-18's stage shapes (batch 16)
   plus ragged shapes, equal to the plain version (``torch.equal``);
3. ``crossbar_gemm`` sliced branch (8-bit ADC / 494 rows, 9-bit / 512)
   on inputs where clips fire, equal to the plain version;
4. ``fb_epilogue`` in every mode against the plain version, to the
   tolerances in ``FB_CASES``;
5. the main path: ``repro_torch.api.compile("resnet18", HurryConfig())``
   at full width, serving request batches of 1, 3 and 16, checked
   against the same weights run on the CPU's plain path; both launch
   counters must grow by one per stage and request;
6. the sliced branch end to end: AlexNet under ``HurryConfig(adc_bits=8)``
   at batch 4 against the CPU's plain path;
7. times: each kernel summed over one batch-16 forward's shapes (device
   time per call from 25 calls captured in a CUDA graph, median of 5
   replays, ``device_ms``) beside its
   bound, its plain version and, for the GEMM, ``torch._int_mm``; and
   ResNet-18's end-to-end time per batch at 1 and 16 (host clock around
   ``run`` and a device synchronize, median of 10), with the device's
   busy time (profiler device events) and idle share of those forwards
   (``forward_profile``).

The line before the last is the JSON record of the kernels; the last is
``{"ok": true, "device": {...}}``.  Any failed check raises before it.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA's data sheet
INT8_OPS_PER_S = 1979e12         # dense int8 tensor-core peak
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


def gemm_bound(M: int, N: int, K: int, sliced: bool) -> tuple[float, float]:
    """(bytes-bound ms, operations-bound ms) of one crossbar GEMM.

    Bytes: each int8 operand read once, the int32 output written once.
    Operations: 2*M*N*K int8 ops; the sliced branch's per-plane counts
    are 64 {0,1} products of the same size, counted as int8 ops.
    """
    nbytes = M * K + K * N + 4 * M * N
    ops = 2 * M * N * K * (64 if sliced else 1)
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3


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
                        res=has_res, out_rows=n_out, w8=st.w8))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import numpy as np
    from repro_torch import api
    from repro_torch.kernels import _build
    from repro_torch.kernels.crossbar_gemm import (clip_possible,
                                                   crossbar_gemm,
                                                   crossbar_gemm_exact_ref,
                                                   crossbar_gemm_ref)
    from repro_torch.kernels.fb_epilogue import fb_epilogue, fb_epilogue_ref

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

    def rand_i8(*shape):
        return torch.randint(-128, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    # shapes of the main path: ResNet-18, default config, batch 16
    resnet_gpu = api.compile("resnet18", api.HurryConfig(), seed=0,
                             device="cuda")
    shapes = stage_shapes(resnet_gpu, 16)

    # -- 2. crossbar_gemm, exact branch ----------------------------------
    gemm_err = 0
    cases = sorted({(s["M"], s["K"], s["N"], s["rows"]) for s in shapes})
    cases += [(1, 27, 10, 27), (37, 101, 19, 27), (1000, 494, 77, 494),
              (129, 1000, 65, 494), (3, 5, 3, 494)]
    for M, K, N, rows in cases:
        x, w = rand_i8(M, K), rand_i8(K, N)
        err = (crossbar_gemm(x, w, rows=rows).long()
               - crossbar_gemm_exact_ref(x, w).long()).abs().max().item()
        gemm_err = max(gemm_err, err)
        check(err == 0, f"crossbar_gemm exact differs at M={M} K={K} N={N}")
    torch.cuda.synchronize()
    log(f"[2 crossbar_gemm exact] {len(cases)} shapes equal to the plain "
        "version (torch.equal)")

    # -- 3. crossbar_gemm, sliced branch ---------------------------------
    sl_cases = [(8, 494, 2048, 988, 64), (8, 494, 1024, 1976, 384),
                (9, 512, 512, 1536, 96), (9, 512, 33, 700, 17),
                (8, 486, 64, 4446, 1024)]
    clipped = sliced_err = 0
    for adc, rows, M, K, N in sl_cases:
        x, w = rand_i8(M, K), rand_i8(K, N)
        x[: M // 4] = -1                     # all bits set: counts = rows
        w[:, : N // 4] = -1
        y = crossbar_gemm(x, w, adc_bits=adc, rows=rows, exact=False)
        ref = crossbar_gemm_ref(x, w, adc_bits=adc, rows=rows)
        err = (y.long() - ref.long()).abs().max().item()
        sliced_err = max(sliced_err, err)
        check(err == 0, f"crossbar_gemm sliced differs at "
              f"adc={adc} rows={rows} M={M} K={K} N={N}")
        check(clip_possible(rows, adc), "sliced case cannot clip")
        clipped += int(not torch.equal(ref, crossbar_gemm_exact_ref(x, w)))
    check(clipped == len(sl_cases), "ADC clips did not fire in every case")
    torch.cuda.synchronize()
    log(f"[3 crossbar_gemm sliced] {len(sl_cases)} shapes equal to the plain "
        f"version, ADC clips fired in {clipped}")

    # -- 4. fb_epilogue, every mode --------------------------------------
    fb_err = 0.0
    parts = []
    for mode, kw, with_res, atol, why in FB_CASES:
        if kw.get("pool") in ("max", "avg"):
            M, N = 16 * kw["img_hw"] ** 2, 512 if kw["pool"] == "avg" else 64
        elif kw.get("softmax"):
            M, N = 16, 10
        else:
            M, N = 16 * 256, 192 if kw.get("norm") else 64
        y = torch.randint(-2 ** 20, 2 ** 20, (M, N), generator=gen,
                          device=dev, dtype=torch.int32)
        scale = torch.full((1, 1), 3.1e-6, device=dev)
        bias = torch.randn(N, generator=gen, device=dev)
        res = torch.randn(M, N, generator=gen, device=dev) if with_res \
            else None
        if kw.get("norm"):
            kw = dict(kw, gamma=torch.randn(N, generator=gen, device=dev),
                      beta=torch.randn(N, generator=gen, device=dev))
        out = fb_epilogue(y, scale, bias, res, **kw)
        ref = fb_epilogue_ref(y, scale, bias, res, **kw)
        err = (out - ref).abs().max().item()
        check(out.shape == ref.shape and err <= atol,
              f"fb_epilogue {mode}: max |kernel - plain| {err} > {atol} "
              f"({why})")
        fb_err = max(fb_err, err)
        parts.append(f"{mode} {err:.2e}")
    torch.cuda.synchronize()
    log("[4 fb_epilogue] max |kernel - plain| per mode: " + ", ".join(parts))

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
    # shape's binding term so the sum can say which one dominates
    g = dict(ms=0.0, plain=0.0, lib=0.0, by={"bytes": 0.0, "operations": 0.0})
    f = dict(ms=0.0, plain=0.0, bound=0.0)
    for s in shapes:
        M, K, N = s["M"], s["K"], s["N"]
        x, w = rand_i8(M, K), s["w8"]
        g_ms = device_ms(lambda: crossbar_gemm(x, w, rows=s["rows"]))
        g_plain = device_ms(lambda: crossbar_gemm_exact_ref(x, w))
        # torch._int_mm's shape rules: M > 16, K and N multiples of 8
        xl = torch.nn.functional.pad(x, (0, -K % 8, 0, max(0, 17 - M)))
        wl = torch.nn.functional.pad(w, (0, -N % 8, 0, -K % 8))
        g_lib = device_ms(lambda: torch._int_mm(xl, wl))
        b_ms, o_ms = gemm_bound(M, N, K, sliced=False)
        g["by"]["bytes" if b_ms >= o_ms else "operations"] += max(b_ms, o_ms)
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
        g["ms"] += g_ms
        g["plain"] += g_plain
        g["lib"] += g_lib
        f["ms"] += f_ms
        f["plain"] += f_plain
        f["bound"] += f_bound
        detail(
            f"time {s['name']}: M={M} K={K} N={N} gemm {g_ms:.4f} ms "
            f"(bound {max(b_ms, o_ms):.5f}, plain {g_plain:.4f}, _int_mm "
            f"{g_lib:.4f}) | epilogue {s['fb']} res={s['res']} {f_ms:.4f} ms "
            f"(bound {f_bound:.5f}, plain {f_plain:.4f})")
    # the AlexNet adc_bits=8 path's GEMMs (batch 4): all but conv1 sliced
    sl = dict(ms=0.0, plain=0.0, by={"bytes": 0.0, "operations": 0.0})
    for s in stage_shapes(alex_gpu, 4):
        M, K, N, rows = s["M"], s["K"], s["N"], s["rows"]
        x, w = rand_i8(M, K), s["w8"]
        is_sliced = clip_possible(min(rows, K), 8)
        s_ms = device_ms(lambda: crossbar_gemm(x, w, adc_bits=8, rows=rows))
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

    g_bound, g_by = bound(g["by"])
    s_bound, s_by = bound(sl["by"])
    log(f"[7 times] per ResNet-18 batch-16 forward: crossbar_gemm "
        f"{g['ms']:.3f} ms (bound {g_bound:.4f} by {g_by}, plain "
        f"{g['plain']:.3f}, torch._int_mm {g['lib']:.3f}); fb_epilogue "
        f"{f['ms']:.3f} ms (bound {f['bound']:.4f} by bytes, plain "
        f"{f['plain']:.3f}); AlexNet adc8 b4 crossbar_gemm {sl['ms']:.3f} ms "
        f"(bound {s_bound:.4f} by {s_by}, plain {sl['plain']:.3f}); "
        f"resnet18 end to end {e2e[1]:.3f} ms at b=1, {e2e[16]:.3f} ms at "
        f"b=16; device idle {idle[1]} at b=1, {idle[16]} at b=16")
    kernels = [
        dict(name="crossbar_gemm", route="cuda",
             source="src/repro_torch/kernels/csrc/crossbar_gemm.cu",
             replaces="src/repro/kernels/crossbar_gemm.py:116",
             launches=main_launches["crossbar_gemm"], max_abs_err=gemm_err,
             ms=g["ms"], plain_ms=g["plain"], bound_ms=g_bound,
             bound_by=g_by, library_ms=g["lib"]),
        dict(name="crossbar_gemm (sliced path)", route="cuda",
             source="src/repro_torch/kernels/csrc/crossbar_gemm.cu",
             replaces="src/repro/kernels/crossbar_gemm.py:77",
             launches=sliced_launches, max_abs_err=sliced_err,
             ms=sl["ms"], plain_ms=sl["plain"], bound_ms=s_bound,
             bound_by=s_by, library_ms=None),
        dict(name="fb_epilogue", route="cuda",
             source="src/repro_torch/kernels/csrc/fb_epilogue.cu",
             replaces="src/repro/kernels/fb_epilogue.py:102",
             launches=main_launches["fb_epilogue"], max_abs_err=fb_err,
             ms=f["ms"], plain_ms=f["plain"], bound_ms=f["bound"],
             bound_by="bytes", library_ms=None),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
