"""Host seconds of ``api.compile``: lowering the graph to its program
and packing the weights on the device."""


def read(run):
    return run.setup["compile_s"]
