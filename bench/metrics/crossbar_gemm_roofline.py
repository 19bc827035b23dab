"""``crossbar_gemm``'s share of its roofline in the traced slice, in percent:
the least time its calls could take (``bench/counts``, at the layers'
logical shapes) over the union of its kernels' device intervals."""


def read(run):
    t = run.trace
    busy = t.busy_s("crossbar_gemm") if t else 0.0
    if not busy:
        return None
    return 100.0 * t.units * run.bound_s["crossbar_gemm"] / busy
