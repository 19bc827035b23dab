"""Readings of the program's own spans on the card, for the eval cells.

    python3 trace_readings.py [--cells resnet18.eval_b1024 ...] \
        [--seconds 3] [--out build/trace_readings.json]

Per cell, set up as ``bench/harness/cell.py`` does (seed 1), then:

* **what tracing costs a request**: the cell's loop for ``--seconds``
  with tracing off, on, on, off: the host clock around each
  ``CompiledModel.run`` call, the mean of the program's ``run`` spans
  (the front door's host time a request), and images/s;
* **where the idle of a traced slice sits**: one test-set pass under
  ``torch.profiler`` with the host recorded (the harness's second
  session), the idle split into before the first replay, inside the
  replays, between replays and after the last, each by the innermost
  span the host was in (the harness's ``bench.*`` or the program's
  ``repro.*``); a replay's extent runs from its first device op to its
  last, inside the device copy of its ``repro.run.replay`` span, and
  the idle inside the extents over their sum is the executor's idle
  share (``replay_idle_pct``);
* **counters a batch** (each counter's growth over the traced slice's
  replays, over its batches): the bytes of x the exact GEMMs load
  (``gemm.x_load_bytes``), the bytes ``quantize_layout``'s own amax
  passes read (``layout.amax_pass_bytes``) and its device kernels
  (``device_kernels.quantize_layout``);
* **the launch plan**: the executable's plan (``Executable.plan``) laid
  over each replay's device ops, wrapper by wrapper in order, so each
  stage's busy time of ``quantize_layout``, ``crossbar_gemm`` and
  ``fb_epilogue`` stands beside that stage's bound (``bench/counts``,
  which counts no tap's store), with the stage's tap where it has one.

Prints a summary; the whole record goes to ``--out``.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))

import torch  # noqa: E402
from torch.profiler import (ProfilerActivity, profile,  # noqa: E402
                            record_function)

from bench.counts import stages as counts  # noqa: E402
from bench.harness import layers as L, manifest, program, traffic  # noqa
from bench.harness.loops import Batches  # noqa: E402
from bench.harness.trace import (HOST_IDLE, KERNELS, SLICE,  # noqa
                                 _length, _union)
from repro_torch import trace  # noqa: E402

SEED = 1
WRAPPERS = counts.WRAPPERS
SPANS = ("bench.", "repro.")            # the harness's and the program's
REPLAY = "repro.run.replay"
# counters read a batch (None where the program has no such counter)
PER_BATCH = ("gemm.x_load_bytes", "layout.amax_pass_bytes",
             "device_kernels.quantize_layout")


def _events(prof) -> tuple[list, list, list]:
    """(device ops, host spans, the device copies of ``REPLAY``) of a
    profiler session, each as (start, end[, name]) seconds.  A span's
    device copy is no device work: it never enters the ops."""
    ops, spans, replays = [], [], []
    for e in prof.events():
        a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
        cuda = e.device_type == torch.autograd.DeviceType.CUDA
        if e.name.startswith(SPANS):
            if not cuda:
                spans.append((a, b, e.name))
            elif e.name == REPLAY:
                replays.append((a, b))
        elif cuda:
            ops.append((a, b, e.name))
    return ops, spans, replays


def _replays(ops, copies) -> list[tuple[float, float, float]]:
    """Each replay's device ops (those inside its span's device copy) as
    (first op's start, last op's end, busy seconds); a copy with no op
    inside is left out."""
    out = []
    for a, b in sorted(copies):
        inside = [(s, e) for s, e, _ in ops if s >= a and e <= b]
        if inside:
            iv = _union(inside)
            out.append((iv[0][0], iv[-1][1], _length(iv)))
    return out


def _gaps(ops, spans, start: float, end: float) -> dict[str, float]:
    """Idle device seconds in [start, end] by the span the host was in:
    the innermost (the latest to open, then the first to close), the
    harness's or the program's; ``HOST_IDLE`` outside every span."""
    idle, t = [], start
    for a, b in _union([(a, b) for a, b, _ in ops]):
        if a > t:
            idle.append((t, a))
        t = max(t, b)
    if end > t:
        idle.append((t, end))
    spans = [s for s in spans if s[2] != SLICE]
    by: dict[str, float] = {}
    for a, b in idle:
        covered = [(max(a, s0), min(b, s1), (s0, -s1), name)
                   for s0, s1, name in spans if min(b, s1) > max(a, s0)]
        cuts = sorted({a, b, *(x for c in covered for x in c[:2])})
        for lo, hi in zip(cuts, cuts[1:]):
            inside = [c for c in covered if c[0] <= lo and c[1] >= hi]
            name = max(inside, key=lambda c: c[2])[3] if inside \
                else HOST_IDLE
            by[name] = by.get(name, 0.0) + (hi - lo)
    return by


class _Clocked:
    """The model with a host clock around each ``run``."""

    def __init__(self, model):
        self.model, self.ns = model, []

    def run(self, x):
        t0 = time.perf_counter_ns()
        out = self.model.run(x)
        self.ns.append(time.perf_counter_ns() - t0)
        return out


def _setup(name: str, device):
    c = manifest.cell(name)
    cfg, mix = manifest.config(c["config"]), manifest.mix(c["traffic"])
    layers = L.infer(cfg)
    gen = torch.Generator(device).manual_seed(SEED)
    params = L.make_params(layers, cfg["init"], gen)
    images = traffic.test_set(mix, cfg, gen)
    model, _ = program.compile_model(cfg, params, device)
    for b in traffic.batch_sizes(mix):
        model.warmup(b)
    loop = Batches(model, images, mix)
    loop.warm()
    torch.cuda.synchronize(device)
    return layers, mix, model, loop


def _cost(loop, model, seconds: float, device) -> list[dict]:
    rows = []
    for on in (False, True, True, False):
        (trace.enable if on else trace.disable)()
        trace.reset()
        clock = loop.model = _Clocked(model)
        stats = loop.run(deadline=time.perf_counter() + seconds)
        torch.cuda.synchronize(device)
        run = trace.totals().get("run")
        rows.append({
            "tracing": on, "runs": len(clock.ns),
            "host_clock_us": sum(clock.ns) / len(clock.ns) / 1e3,
            "run_span_us": 1e6 * run["seconds"] / run["count"] if run
            else None,
            "images_per_s": stats["images"] / stats["seconds"]})
    loop.model = model
    loop.answers.clear()
    trace.disable()
    return rows


def _clip(ops, lo, hi):
    return [(max(a, lo), min(b, hi), n) for a, b, n in ops
            if b > lo and a < hi]


def _slice(loop, device, units: int):
    """One pass of ``units`` batches under the host-and-device profiler:
    its ops, spans, replay extents and limits, and each ``PER_BATCH``
    counter a batch."""
    trace.enable()
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda._sleep(1000)
        torch.cuda.synchronize(device)
    before = trace.counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(SLICE):
            loop.run(units=units)
            torch.cuda.synchronize(device)
    after = trace.counters()
    per_batch = {k: (after[k] - before.get(k, 0)) // units
                 if k in after else None for k in PER_BATCH}
    trace.disable()
    loop.answers.clear()
    ops, spans, copies = _events(prof)
    start, end = next((a, b) for a, b, n in spans if n == SLICE)
    ext = _replays(ops, copies)
    if not ext:
        raise SystemExit(f"the profiler gave no device copy of {REPLAY}")
    return _clip(ops, start, end), spans, ext, start, end, per_batch


def _idle(ops, spans, ext, start, end) -> dict:
    """Idle seconds of the slice by region, each by span."""
    regions = {"before the first replay": [(start, ext[0][0])],
               "inside the replays": [(a, b) for a, b, _ in ext],
               "between replays": [(ext[i][1], ext[i + 1][0])
                                   for i in range(len(ext) - 1)],
               "after the last replay": [(ext[-1][1], end)]}
    out = {}
    for name, spans_of in regions.items():
        by: dict[str, float] = {}
        for lo, hi in spans_of:
            if hi <= lo:
                continue
            for k, v in _gaps(_clip(ops, lo, hi), spans, lo, hi).items():
                by[k] = by.get(k, 0.0) + v
        out[name] = {"idle_s": sum(by.values()), "by_span": by}
    out["slice_s"] = end - start
    extent = sum(b - a for a, b, _ in ext)
    out["replay_idle_pct"] = 100.0 * out["inside the replays"]["idle_s"] \
        / extent
    out["busy_s"] = _length(_union([(a, b) for a, b, _ in ops]))
    return out


def _kernel_wrappers() -> dict[str, str]:
    """Kernel function -> wrapper, from the ``__global__`` functions each
    wrapper's ``csrc/<wrapper>.cu`` defines: the kernels of shapes the
    benchmark's map (``bench/kernels.json``) has not seen."""
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    return {fn: w for w in WRAPPERS for fn in re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)"
        r"\s+)?(\w+)\s*\(",
        (csrc / f"{w}.cu").read_text())}


def _wrapper_of(name: str, names: dict, defined: dict) -> str | None:
    if name in names:
        return names[name]
    m = re.search(r"\(anonymous namespace\)::(\w+)", name)
    return defined.get(m.group(1)) if m else None


def _kernels(step, w: str) -> int:
    """A plan step's device kernels of wrapper ``w``: its count of them
    where it keeps one (``device_kernels.<w>``), else one a launch."""
    return step.counts.get(f"device_kernels.{w}",
                           step.counts.get(f"launches.{w}", 0))


def _plan_table(ops, ext, plan, layers, batch) -> list[dict]:
    """Each stage's busy seconds a replay per wrapper (union of its
    kernels' intervals), beside its bound."""
    names, defined = json.loads(KERNELS.read_text()), _kernel_wrappers()
    busy = [{w: [] for w in WRAPPERS} for _ in plan]
    for a, b, _ in ext:
        seq = {w: [] for w in WRAPPERS}
        for s, e, n in sorted(o for o in ops if o[0] >= a and o[1] <= b):
            w = _wrapper_of(n, names, defined)
            if w in seq:
                seq[w].append((s, e))
        for w in WRAPPERS:
            want = sum(_kernels(step, w) for step in plan)
            if len(seq[w]) != want:
                raise RuntimeError(f"{w}: {len(seq[w])} kernels in a "
                                   f"replay, the plan holds {want}")
            it = iter(seq[w])
            for i, step in enumerate(plan):
                busy[i][w] += [next(it) for _ in range(_kernels(step, w))]
    stage = {s.name: s for s in counts.stages(layers)}
    rows = []
    for step, by in zip(plan, busy):
        s = stage[step.layer]
        nbytes = counts.stage_bytes(s, batch)
        ops_ = 2 * s.S * batch * s.M * s.K * s.N
        row = {"layer": step.layer, "tap": step.tap, "counts": step.counts}
        for w in WRAPPERS:
            bound = max(nbytes[w] / counts.HBM_BYTES_PER_S,
                        (ops_ if w == "crossbar_gemm" else 0)
                        / counts.INT8_OPS_PER_S)
            row[w] = {"busy_ms": 1e3 * _length(_union(by[w])) / len(ext),
                      "bound_ms": 1e3 * bound}
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", nargs="+", default=[
        "resnet18.eval_b1024", "vit_tiny.eval_b1024"])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="build/trace_readings.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_readings.py needs a GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    record = {"device": torch.cuda.get_device_name(device)}
    for name in args.cells:
        layers, mix, model, loop = _setup(name, device)
        cost = _cost(loop, model, args.seconds, device)
        ops, spans, ext, start, end, per_batch = _slice(loop, device,
                                                        loop.n)
        (exe,) = model._fns.values()
        idle = _idle(ops, spans, ext, start, end)
        try:
            table = _plan_table(ops, ext, exe.plan, layers, mix["batch"])
        except RuntimeError as e:       # the plan does not fit the trace
            print(f"  no plan table: {e}")
            table = []
        record[name] = {"cost": cost, "idle": idle, "plan": table,
                        "replays": len(ext), "per_batch": per_batch}
        print(f"== {name}: {len(ext)} replays, {len(exe.plan)} stages; a "
              "batch: " + ", ".join(f"{k} {n}" for k, n in per_batch.items()))
        for r in cost:
            print(f"  tracing {'on ' if r['tracing'] else 'off'}: host "
                  f"{r['host_clock_us']:.1f} us a run, span "
                  f"{r['run_span_us'] or 0:.1f} us, "
                  f"{r['images_per_s']:.0f} images/s ({r['runs']} runs)")
        print(f"  slice {1e3 * idle['slice_s']:.3f} ms, busy "
              f"{1e3 * idle['busy_s']:.3f} ms, idle inside the replays "
              f"{idle['replay_idle_pct']:.4f}% of their extents")
        for region in ("before the first replay", "inside the replays",
                       "between replays", "after the last replay"):
            r = idle[region]
            top = sorted(r["by_span"].items(), key=lambda kv: -kv[1])[:4]
            print(f"  idle {region}: {1e3 * r['idle_s']:.3f} ms "
                  + ", ".join(f"{k} {1e3 * v:.3f}" for k, v in top))
        for row in table:
            print(f"  {row['layer']:16s} " + "  ".join(
                f"{w} {row[w]['busy_ms']:.3f}/{row[w]['bound_ms']:.3f}"
                for w in WRAPPERS)
                + (f"  tap {row['tap']}" if row["tap"] else ""))
        model._fns.clear()
        del model, loop
        torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
