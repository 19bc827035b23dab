"""The port's spans and counters (``repro_torch.trace``), on the CPU.

Off, a span is one shared null context and records nothing; on, spans
nest, carry their run's request id, give self times, stay within their
ring and reach ``torch.profiler`` as ``repro.<name>`` ranges.  The front
door's, the executor's and the kernel build's spans and counters are
held here on CPU runs, stand-in graphs and a stand-in compiler; the
capture's spans run on the card.
"""

import collections
import ctypes.util
import importlib
import subprocess
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import api, trace
from repro_torch.kernels import crossbar_gemm, fb_epilogue, quantize_layout
from repro_torch.kernels.quantize_layout import DEVICE_KERNELS, device_kernels
from repro_torch.program import execute
from repro_torch.program.serve import Executable

from test_torch_cuda import _token_graph

_build = importlib.import_module("repro_torch.kernels._build")


@pytest.fixture(autouse=True)
def _fresh():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _tokens(b, t=16, d=32, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (b, t, d)).astype(np.float32))


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------

def test_off_returns_the_shared_null_context_and_records_nothing():
    assert trace.span("run") is trace.NULL
    assert trace.span("stage", layer="conv0") is trace.NULL
    with trace.span("run") as s:
        with trace.span("run.replay"):
            pass
    assert s is trace.NULL
    assert trace.spans() == [] and trace.totals() == {}
    trace.count("rows", 3)                      # counters are always on
    assert trace.counters()["rows"] == 3


def test_nesting_parents_requests_and_self_time():
    trace.enable()
    with trace.span("compile"):
        pass
    for _ in range(2):
        with trace.span("run"):
            with trace.span("run.copy_in"):
                time.sleep(0.002)
            with trace.span("run.replay", note="x"):
                time.sleep(0.001)
    got = trace.spans()
    by = {}
    for s in got:
        by.setdefault(s.name, []).append(s)
    assert [s.name for s in got] == ["compile", "run.copy_in", "run.replay",
                                     "run", "run.copy_in", "run.replay",
                                     "run"]
    assert by["compile"][0].parent is None
    assert by["compile"][0].request is None
    for i, run in enumerate(by["run"]):
        assert run.parent is None and run.request == run.id
        for child in (by["run.copy_in"][i], by["run.replay"][i]):
            assert child.parent == run.id and child.request == run.id
            assert run.start_ns <= child.start_ns <= child.end_ns \
                <= run.end_ns
    assert by["run"][0].request != by["run"][1].request
    assert by["run.replay"][0].attrs == {"note": "x"}
    tot = trace.totals()
    assert tot["run"]["count"] == 2 and tot["run.replay"]["count"] == 2
    inner = sum(s.end_ns - s.start_ns for n in ("run.copy_in", "run.replay")
                for s in by[n])
    outer = sum(s.end_ns - s.start_ns for s in by["run"])
    assert tot["run"]["seconds"] == pytest.approx(outer / 1e9)
    assert tot["run"]["self_seconds"] == pytest.approx((outer - inner) / 1e9)
    assert tot["run.copy_in"]["self_seconds"] == pytest.approx(
        tot["run.copy_in"]["seconds"])
    assert tot["run.copy_in"]["seconds"] >= 0.004


def test_the_ring_keeps_the_newest_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(trace, "_ring", collections.deque(maxlen=4))
    trace.enable()
    for i in range(6):
        with trace.span("stage", layer=f"l{i}"):
            pass
    assert [s.attrs["layer"] for s in trace.spans()] == ["l2", "l3", "l4",
                                                         "l5"]
    assert trace.counters()["spans.dropped"] == 2
    trace.reset()
    assert trace.spans() == [] and "spans.dropped" not in trace.counters()


def test_timed_reads_the_clock_whether_on_or_off():
    with trace.timed("capture") as off:
        time.sleep(0.001)
    assert off.seconds >= 0.001 and trace.spans() == []
    trace.enable()
    with trace.timed("capture") as on:
        time.sleep(0.001)
    (s,) = trace.spans()
    assert s.name == "capture" and s.seconds == on.seconds


def test_counters_report_the_wrappers_launches_since_reset(monkeypatch):
    trace.reset()
    monkeypatch.setattr(crossbar_gemm, "launches", crossbar_gemm.launches + 5)
    got = trace.counters()
    assert got["launches.crossbar_gemm"] == 5
    assert got["launches.quantize_layout"] == 0
    trace.reset()
    monkeypatch.setattr(fb_epilogue, "launches", fb_epilogue.launches + 2)
    assert trace.counters()["launches.crossbar_gemm"] == 0
    assert trace.counters()["launches.fb_epilogue"] == 2


@pytest.mark.parametrize("on", [False, True])
def test_the_profiler_sees_repro_ranges_only_when_on(on):
    if on:
        trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("run"):
            torch.ones(4).add_(1)
    names = {e.name for e in prof.events()}
    assert ("repro.run" in names) == on


# ---------------------------------------------------------------------------
# the program's spans and counters
# ---------------------------------------------------------------------------

def test_run_bucketed_on_the_cpu_spans_and_counts_rows():
    model = api.compile(_token_graph(), seed=3, device="cpu")
    trace.reset()
    trace.enable()
    model.run(_tokens(3))
    tot, counters = trace.totals(), trace.counters()
    assert tot["run"]["count"] == 1 and tot["run.stage_in"]["count"] == 1
    assert counters["rows"] == 3 and counters["padded_rows"] == 1
    run = next(s for s in trace.spans() if s.name == "run")
    stages = [s for s in trace.spans() if s.name == "stage"]
    layers = [gemm.name for gemm, _ in model.program.stages()]
    assert [s.attrs["layer"] for s in stages] == layers
    assert all(s.request == run.id and s.parent == run.id for s in stages)
    assert "run.capture" not in tot              # the CPU path is eager


def test_compile_spans():
    trace.enable()
    api.compile(_token_graph(), seed=3, device="cpu")
    tot = trace.totals()
    for name in ("compile", "compile.lower", "compile.params",
                 "compile.pack"):
        assert tot[name]["count"] == 1, name
    assert tot["compile"]["self_seconds"] < tot["compile"]["seconds"]


def test_execute_packed_keeps_the_launch_plan(monkeypatch):
    """With stand-ins that count as the card's wrappers do, each stage's
    step holds its calls and their device kernels, in order."""
    model = api.compile(_token_graph(), seed=3, device="cpu")

    def counting(fn, kernels):
        def spy(*a, **kw):
            fn.launches += 1
            trace.count(DEVICE_KERNELS, kernels(*a, **kw))
            return fn(*a, **kw)
        return spy

    none = lambda *a, **kw: 0                   # noqa: E731
    monkeypatch.setattr(execute, "quantize_layout",
                        counting(quantize_layout, device_kernels))
    monkeypatch.setattr(execute, "crossbar_gemm",
                        counting(crossbar_gemm, none))
    monkeypatch.setattr(execute, "fb_epilogue", counting(fb_epilogue, none))
    plan = []
    x = _tokens(2)
    got = execute.execute_packed(model.packed, x, plan=plan)
    assert torch.equal(got, execute.execute_packed(model.packed, x))
    stages = model.program.stages()
    assert [p.layer for p in plan] == [g.name for g, _ in stages]
    for step, (gemm, _) in zip(plan, stages):
        quants = 2 if gemm.kind == "dyn_gemm" else 1
        assert step.calls == {"quantize_layout": quants, "crossbar_gemm": 1,
                              "fb_epilogue": 1}
        assert step.kernels["crossbar_gemm"] == 1
        assert step.kernels["fb_epilogue"] == 1
        assert step.kernels["quantize_layout"] >= quants
    assert sum(p.kernels["quantize_layout"] for p in plan) == \
        trace.counters()[DEVICE_KERNELS] // 2   # two runs, one planned


class _StandInGraph:
    def __init__(self, x, out):
        self.x, self.out = x, out

    def replay(self):
        self.out.copy_(self.x + 1)


def test_a_replay_spans_its_steps_and_adds_its_device_kernels():
    x, out = torch.zeros(4, 3), torch.zeros(4, 3)
    exe = Executable(graph=_StandInGraph(x, out), x=x, out=out, pool=(0, 0),
                     launches={quantize_layout: 2}, capture_s=0.0,
                     kernels=7)
    trace.enable()
    with trace.span("run"):
        got = exe(torch.ones(4, 3), 3)
    assert torch.equal(got, torch.full((3, 3), 2.0))
    names = [s.name for s in trace.spans()]
    assert names == ["run.copy_in", "run.replay", "run.copy_out", "run"]
    counters = trace.counters()
    assert counters[DEVICE_KERNELS] == 7
    assert counters["launches.quantize_layout"] == 2


def test_a_kernel_load_is_a_span_and_counts(monkeypatch, tmp_path):
    libc = ctypes.util.find_library("c") or "libc.so.6"   # a stand-in

    def fake_nvcc(cmd, **kw):
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb"):
            pass
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_nvcc)
    assert _build.build("fb_epilogue").exists()
    _build.build("fb_epilogue")                 # built already: no count
    assert trace.counters()["kernels.built"] == 1
    monkeypatch.setattr(_build, "build", lambda name: libc)
    trace.enable()
    _build.load.__wrapped__("crossbar_gemm")
    (s,) = trace.spans()
    assert s.name == "kernels.load" and s.attrs == {"library":
                                                    "crossbar_gemm"}
    assert trace.counters()["kernels.loaded"] == 1


# ---------------------------------------------------------------------------
# the readings of a profiled slice (``trace_readings.py``)
# ---------------------------------------------------------------------------

def _readings():
    """``trace_readings.py`` at the repo's root (sys.path as it was)."""
    import sys
    from pathlib import Path
    saved = list(sys.path)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    try:
        return importlib.import_module("trace_readings")
    finally:
        sys.path[:] = saved


def _event(name, a_us, b_us, cuda):
    kind = torch.autograd.DeviceType.CUDA if cuda else \
        torch.autograd.DeviceType.CPU
    return types.SimpleNamespace(
        name=name, device_type=kind,
        time_range=types.SimpleNamespace(start=a_us, end=b_us))


def _prof(events):
    return types.SimpleNamespace(events=lambda: events)


def test_events_take_program_ranges_as_spans_and_replay_copies_apart():
    tr = _readings()
    ops, spans, copies = tr._events(_prof([
        _event("bench.run", 0, 10, False),
        _event("repro.run", 1, 9, False),
        _event("repro.run.replay", 2, 5, False),
        _event("repro.run.replay", 3, 8, True),     # its device copy
        _event("repro.run.copy_in", 2, 3, True),    # another span's copy
        _event("bench.run", 0, 10, True),
        _event("k_q", 3, 4, True),
        _event("k_g", 5, 7, True),
        _event("aten::copy_", 2, 3, False)]))
    assert ops == [(3e-6, 4e-6, "k_q"), (5e-6, 7e-6, "k_g")]
    assert [n for _, _, n in spans] == ["bench.run", "repro.run",
                                        "repro.run.replay"]
    assert copies == [(3e-6, 8e-6)]
    assert not any(n.startswith(("repro.", "bench.")) for _, _, n in ops)


def test_replay_extents_run_from_first_op_to_last_inside_the_copy():
    tr = _readings()
    ops = [(1.0, 2.0, "k_q"), (1.5, 2.5, "k_q"), (3.0, 4.0, "k_g"),
           (6.0, 7.0, "k_f"), (9.0, 9.5, "copy")]
    ext = tr._replays(ops, [(5.5, 8.0), (0.5, 4.5), (8.5, 8.9)])
    assert ext == [(1.0, 4.0, pytest.approx(2.5)), (6.0, 7.0, 1.0)]


def test_gaps_take_the_innermost_span_and_sum_to_the_idle():
    tr = _readings()
    ops = [(0.0, 1.0, "k_q"), (2.0, 3.0, "k_g"), (5.0, 6.0, "k_f")]
    spans = [(0.0, 10.0, tr.SLICE), (0.0, 4.0, "bench.run"),
             (0.5, 3.5, "repro.run"), (1.0, 3.5, "repro.run.replay"),
             (4.0, 9.0, "bench.copy_back")]
    gaps = tr._gaps(ops, spans, 0.0, 10.0)
    # 1..2 and 3..3.5 under the replay, never the run or bench.run round it
    assert gaps["repro.run.replay"] == pytest.approx(1.5)
    assert "repro.run" not in gaps
    assert gaps["bench.run"] == pytest.approx(0.5)             # 3.5..4
    assert gaps["bench.copy_back"] == pytest.approx(1.0 + 3.0)
    assert gaps[tr.HOST_IDLE] == pytest.approx(1.0)            # 9..10
    assert sum(gaps.values()) == pytest.approx(10.0 - 3.0)


def test_idle_by_region_and_the_replays_idle_share():
    tr = _readings()
    ops = [(1.0, 2.0, "k_q"), (3.0, 4.0, "k_g"), (6.0, 8.0, "k_f")]
    spans = [(0.0, 4.5, "repro.run"), (4.5, 9.0, "repro.run")]
    ext = tr._replays(ops, [(0.5, 4.2), (5.0, 8.5)])
    idle = tr._idle(ops, spans, ext, 0.0, 10.0)
    assert idle["before the first replay"]["idle_s"] == pytest.approx(1.0)
    assert idle["inside the replays"]["idle_s"] == pytest.approx(1.0)
    assert idle["between replays"]["idle_s"] == pytest.approx(2.0)
    assert idle["after the last replay"]["idle_s"] == pytest.approx(2.0)
    assert idle["replay_idle_pct"] == pytest.approx(100 * 1.0 / 5.0)
    assert idle["busy_s"] == pytest.approx(4.0)
