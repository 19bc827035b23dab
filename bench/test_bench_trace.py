"""The reduction of a traced slice, on a made-up trace: busy time as a
union of intervals, a wrapper's time, idle gaps by host span, and the
readers that find nothing to read returning nothing."""

import pytest

from bench.harness import manifest
from bench.harness.cell import Run, _compare
from bench.harness.trace import HOST_IDLE, Trace, _gaps

import numpy as np

KERNELS = {"k_q": "quantize_layout", "k_g": "crossbar_gemm",
           "k_f": "fb_epilogue"}


def _trace():
    # overlapping dependent launches (q twice), a gap, then g and f
    ops = [(0.0, 2.0, "k_q"), (1.0, 3.0, "k_q"), (4.0, 6.0, "k_g"),
           (6.0, 7.0, "k_f"), (7.5, 8.0, "other")]
    gaps = _gaps(ops, [(0.0, 3.5, "bench.run"), (3.5, 10.0,
                                                  "bench.copy_back")],
                 0.0, 10.0)
    return Trace(10.0, ops, 2, 2048, gaps, KERNELS)


def test_busy_is_a_union():
    t = _trace()
    assert t.busy_s() == pytest.approx(3.0 + 2.0 + 1.0 + 0.5)
    assert t.busy_s("quantize_layout") == pytest.approx(3.0)
    assert t.busy_s("crossbar_gemm") == pytest.approx(2.0)
    assert t.device_ops()[0] == ["quantize_layout: k_q", 4.0]
    assert ["unmapped: other", 0.5] in t.device_ops()


def test_idle_gaps_by_span():
    t = _trace()
    gaps = dict(t.idle_gaps())
    assert gaps["bench.run"] == pytest.approx(0.5)
    assert gaps["bench.copy_back"] == pytest.approx(0.5 + 0.5 + 2.0)
    assert HOST_IDLE not in gaps
    assert sum(gaps.values()) == pytest.approx(10.0 - t.busy_s())


def test_readers_on_a_trace_and_without_one():
    t = _trace()
    stats = {"images": 2048, "seconds": 1.0}
    run = Run(stats, {"compile_s": 0.5, "capture_s": 0.25}, t,
              {"quantize_layout": 0.5, "crossbar_gemm": 1.0,
               "fb_epilogue": 0.25}, 1000)
    bare = Run({}, {"compile_s": 0.5, "capture_s": 0.0}, None, {}, 1000)
    want = {"quantize_layout_roofline": 100 * 2 * 0.5 / 3.0,
            "crossbar_gemm_roofline": 100.0,
            "fb_epilogue_roofline": 50.0,
            "device_idle.eval": 100 * (1 - 6.5 / 10),
            "mfu.eval": 100 * 2 * 1000 * 2048 / 10 / 1979e12,
            "compile_pack_s": 0.5, "capture_s": 0.25}
    for m in manifest.manifest()["per_layer"]:
        read = manifest.reader(m["name"])
        assert read(run) == pytest.approx(want[m["name"]]), m["name"]
        if m["name"] != "compile_pack_s":
            assert read(bare) is None, m["name"]


def test_compare_numbers():
    p = np.array([[0.7, 0.2, 0.1], [0.5, 0.25, 0.25]], np.float32)
    same = _compare([(p, p)])
    assert all(v == 0 for v in same.values())
    q = p.copy()
    q[0, [0, 2]] = q[0, [2, 0]]
    d = _compare([(q, p)])
    assert d["max_abs"] == pytest.approx(0.6)
    assert d["logit_max"] == pytest.approx(np.log(7))
    assert d["rel_l2"] > 0 and d["logit_rel_l2"] > 0
    assert _compare([(p * np.nan, p)])["max_abs"] == float("inf")
