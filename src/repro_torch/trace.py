"""Spans and counters of the port, on the clock ``torch.profiler`` reads.

Off by default.  ``span(name, **attrs)`` then returns one shared null
context: a check of the module flag, no allocation, no clock read.  After
``enable()`` a span records, in a ring of the newest ``KEEP`` spans, its
name, its start and end (``time.perf_counter_ns``), the span it opened
in, its request and its attrs, and, while a profiler runs, enters
``torch.profiler.record_function("repro.<name>")``, so the profiler
places it beside the device's kernels.  A ``run`` span starts a
request; every span opened inside it carries the run's id as its
``request``.  What the ring overflows is counted in ``spans.dropped``.

Counters (``count``) are always on, and this module is their one
store: the kernel wrappers count their launches in
``launches.<wrapper>``, the executor its bytes.  A counter counts what
ran: an eager call when it runs; a CUDA graph's recording nothing, its
counts kept aside by ``recording()``; each replay what its recording
counted (``add``)::

    from repro_torch import trace
    trace.enable()
    model.run(x)
    trace.totals()["run.replay"]   # {"count", "seconds", "self_seconds"}
    trace.counters()               # {"rows": ..., "launches.crossbar_gemm": ...}

State is per process: the module's flag, ring and counters.  Spans nest
per thread.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import NamedTuple

import torch
from torch.profiler import record_function

KEEP = 65536                  # spans the ring holds

_on = False
_ring: collections.deque = collections.deque(maxlen=KEEP)
_counters: dict[str, int] = {}
_ids = itertools.count(1)


class _Local(threading.local):
    """Per thread: the open spans, and the counts of a recording
    (``recording``; None outside one)."""

    def __init__(self):
        self.stack: list = []
        self.recorded: dict | None = None


_local = _Local()
# whether a profiler runs: a range costs microseconds, and only a profiler
# reads it (where torch cannot tell, every span enters one)
_profiling = getattr(torch._C._autograd, "_profiler_enabled", lambda: True)


class Span(NamedTuple):
    """One closed span; times in ``time.perf_counter_ns``."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None
    request: int | None
    attrs: dict

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class _Null:
    """The span of a tracer that is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None


NULL = _Null()


class _Timer:
    """A host clock around a block (``timed`` while tracing is off)."""

    __slots__ = ("start_ns", "end_ns")

    def __enter__(self):
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class _Open(_Timer):
    """A span being recorded."""

    __slots__ = ("name", "attrs", "id", "parent", "request", "_range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _local.stack
        top = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = top.id if top else None
        self.request = self.id if self.name == "run" else (
            top.request if top else None)
        stack.append(self)
        self._range = None
        if _profiling():
            self._range = record_function(f"repro.{self.name}")
            self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        stack = _local.stack
        if stack and stack[-1] is self:
            stack.pop()
        if len(_ring) == _ring.maxlen:    # the ring's own: never diverted
            _counters["spans.dropped"] = _counters.get("spans.dropped", 0) + 1
        _ring.append(Span(self.name, self.start_ns, self.end_ns, self.id,
                          self.parent, self.request, self.attrs))


def span(name: str, **attrs):
    """A span around a step of the program (a context manager): the
    shared ``NULL`` while tracing is off."""
    if not _on:
        return NULL
    return _Open(name, attrs)


def timed(name: str, **attrs):
    """``span`` for a step that also needs its own duration (set-up
    only: it reads the clock even while tracing is off): the context's
    ``seconds`` after the block, the recorded span's when tracing is on."""
    return _Open(name, attrs) if _on else _Timer()


def _store() -> dict[str, int]:
    """Where this thread counts: its recording's dict, or the counters."""
    store = _local.recorded
    return _counters if store is None else store


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (always on), or, inside
    ``recording()`` on this thread, to what the recording counted."""
    store = _store()
    store[name] = store.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Around the recording of a CUDA graph, which runs nothing on the
    device: this thread's counts go to the dict it yields, not to the
    counters; ``add`` that dict at each replay."""
    outer, _local.recorded = _local.recorded, {}
    try:
        yield _local.recorded
    finally:
        _local.recorded = outer


def add(counts: dict[str, int]) -> None:
    """``count`` each of ``counts``: a replay of what a recording
    counted."""
    store = _store()
    for name, n in counts.items():
        store[name] = store.get(name, 0) + n


def enable() -> None:
    """Record spans from now on."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording spans (what was recorded stays until ``reset``)."""
    global _on
    _on = False


def reset() -> None:
    """Forget the spans and the counters."""
    _ring.clear()
    _counters.clear()


def spans() -> list[Span]:
    """The recorded spans, oldest first (in the order they closed)."""
    return list(_ring)


def counters() -> dict[str, int]:
    """Every counter counted since the last ``reset`` (a name never
    counted has no key)."""
    return dict(_counters)


def totals() -> dict[str, dict]:
    """Per span name: ``count``, ``seconds`` (summed durations) and
    ``self_seconds`` (each duration less what its children's spans
    cover of it), over the spans in the ring."""
    recorded = list(_ring)
    children: dict[int, list[Span]] = {}
    for s in recorded:
        if s.parent is not None:
            children.setdefault(s.parent, []).append(s)
    out: dict[str, dict] = {}
    for s in recorded:
        covered, t = 0, s.start_ns
        for c in sorted(children.get(s.id, ()), key=lambda c: c.start_ns):
            lo, hi = max(c.start_ns, t), min(c.end_ns, s.end_ns)
            if hi > lo:
                covered += hi - lo
                t = hi
        row = out.setdefault(s.name, {"count": 0, "seconds": 0.0,
                                      "self_seconds": 0.0})
        row["count"] += 1
        row["seconds"] += s.seconds
        row["self_seconds"] += (s.end_ns - s.start_ns - covered) / 1e9
    return out
