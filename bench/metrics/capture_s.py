"""Host seconds the program's executables took to warm up and capture,
summed over the cell's keys (``Executable.capture_s``)."""


def read(run):
    return run.setup["capture_s"] or None
