"""The device's idle share of the traced slice, in percent: one less the
union of all device activity intervals over the slice's length."""


def read(run):
    t = run.trace
    return 100.0 * (1.0 - t.busy_s() / t.window_s) if t else None
