"""A traced slice: ``torch.profiler`` over a short steady stretch of the
cell's own loop, reduced to device intervals and host spans.

Busy time is the union of the device's activity intervals (kernels,
copies, sets): a dependent launch's span can hold its wait on the
kernel before it, so summed spans can pass the wall.  A wrapper's time
is the union of its kernels' intervals; which kernel belongs to which
wrapper is data (``bench/kernels.json``: full name as the profiler
prints it -> wrapper), and a name it does not list is ``unmapped``.
The harness's own spans (``record_function``, named ``bench.*``) label
the idle gaps by what the host was doing, in a second session: a
session that records the host's calls slows the host by some tens of
microseconds a call, which would inflate the idle share of a cell
the host paces.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

KERNELS = Path(__file__).resolve().parents[1] / "kernels.json"
SLICE = "bench.slice"
HOST_IDLE = "bench (outside the spans)"


def span(name: str):
    """A harness span around a call into a layer (``bench.<name>``)."""
    return record_function(f"bench.{name}")


@dataclasses.dataclass
class Trace:
    """A profiled slice: its length in seconds, the device's ops in it as
    (start, end, name) seconds, the work done in it (``units`` batches,
    ``images``), and the idle device seconds by the harness
    span the host was in (``gaps``)."""

    window_s: float
    ops: list[tuple[float, float, str]]
    units: int
    images: int
    gaps: dict[str, float]
    kernels: dict[str, str] = dataclasses.field(default_factory=dict)

    def wrapper(self, name: str) -> str:
        return self.kernels.get(name, "unmapped")

    def busy_s(self, wrapper: str | None = None) -> float:
        """Union of the device intervals (of ``wrapper``'s kernels)."""
        return _length(_union([(a, b) for a, b, n in self.ops
                               if wrapper is None
                               or self.wrapper(n) == wrapper]))

    def device_ops(self, top: int = 10) -> list[list]:
        by: dict[str, float] = {}
        for a, b, n in self.ops:
            key = f"{self.wrapper(n)}: {n}"
            by[key] = by.get(key, 0.0) + (b - a)
        return _top(by, top)

    def idle_gaps(self, top: int = 10) -> list[list]:
        return _top(self.gaps, top)


def _top(by: dict[str, float], top: int) -> list[list]:
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
            [:top]]


def _gaps(ops, spans, start: float, end: float) -> dict[str, float]:
    """Idle device seconds in [start, end] by the harness span the host
    was in (the innermost one; ``HOST_IDLE`` outside every span)."""
    gaps, t = [], start
    for a, b in _union([(a, b) for a, b, _ in ops]):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if end > t:
        gaps.append((t, end))
    spans = sorted((s for s in spans if s[2] != SLICE), key=lambda s: s[0])
    starts = [s[0] for s in spans]
    by: dict[str, float] = {}
    for a, b in gaps:
        i = bisect.bisect_right(starts, b)
        covered = [(max(a, s0), min(b, s1), name)
                   for s0, s1, name in spans[max(0, i - 64):i]
                   if min(b, s1) > max(a, s0)]
        cuts = sorted({a, b, *(x for c in covered for x in c[:2])})
        for lo, hi in zip(cuts, cuts[1:]):
            inside = [c for c in covered if c[0] <= lo and c[1] >= hi]
            name = max(inside, key=lambda c: c[0])[2] if inside \
                else HOST_IDLE
            by[name] = by.get(name, 0.0) + (hi - lo)
    return by


def _union(iv: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _length(iv: list[tuple[float, float]]) -> float:
    return sum(b - a for a, b in iv)


def _events(prof) -> tuple[list, list]:
    ops, spans = [], []
    for e in prof.events():
        a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
        cuda = e.device_type == torch.autograd.DeviceType.CUDA
        if e.name.startswith("bench."):
            if not cuda:         # the device copy of a span is no work
                spans.append((a, b, e.name))
        elif cuda:
            ops.append((a, b, e.name))
    return ops, spans


def profile_slice(body, device: torch.device) -> Trace:
    """Profile ``body()`` (which returns the (units, images) it served)
    twice, after a short warm session (a process's first session loses
    device events).  The first session traces the device alone, so the
    host runs at its own pace: busy time, the wrappers' times and the
    device ops come from it, over the slice's length on the host clock.
    The second also records the host (every PyTorch call, which slows
    the host's side), and only labels the idle gaps."""
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda._sleep(1000)
        torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        units, images = body()
        torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
    ops, _ = _events(prof)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(SLICE):
            body()
            torch.cuda.synchronize(device)
    ops_b, spans = _events(prof)
    start, end = next((a, b) for a, b, n in spans if n == SLICE)
    ops_b = [(max(a, start), min(b, end), n) for a, b, n in ops_b
             if b > start and a < end]
    tr = Trace(window, ops, units, images, _gaps(ops_b, spans, start, end),
               json.loads(KERNELS.read_text()))
    for name in sorted({n for _, _, n in ops if n not in tr.kernels}):
        print(f"unmapped device op: {name}", file=sys.stderr)
    if not ops:
        raise RuntimeError("the profiler saw no device work in the slice")
    return tr
