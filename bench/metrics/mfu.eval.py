"""Useful int8 operations of the whole forward over the traced slice,
as a share of the H100's dense int8 peak, in percent: two operations a
multiply-accumulate of every GEMM at its logical shape (the attention
products included), times the images the slice served, over the
slice's seconds."""

from bench.counts.stages import INT8_OPS_PER_S


def read(run):
    t = run.trace
    if not t or not t.images:
        return None
    return 100.0 * 2 * run.macs * t.images / t.window_s / INT8_OPS_PER_S
