"""repro_torch — the PyTorch/CUDA port of the HURRY reproduction.

It sits beside the JAX package ``repro`` (the reference) with the same
subpackages: ``core`` (crossbar numerics, layer specs, FB scheduling),
``kernels`` (hand-written Hopper kernels beside their plain PyTorch
versions), ``program`` (compile, pack, execute) and ``api`` (the front
door).  It imports torch and numpy, never JAX::

    from repro_torch import api
    model = api.compile("resnet18", api.HurryConfig())   # on the GPU
    probs = model.run(x)
"""
