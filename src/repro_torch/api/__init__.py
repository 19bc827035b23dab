"""``repro_torch.api`` — the front door of the port.

Author a network with ``NetworkBuilder``, configure it with one
``HurryConfig``, then::

    model = api.compile(graph, config)   # scheduler -> CrossbarProgram
    probs = model.run(x)                 # CUDA crossbar + fused-FB kernels

The paper CNNs and ``vit_tiny`` live in ``repro_torch.api.zoo``.
"""

from .config import HurryConfig
from .graph import NetworkBuilder, NetworkGraph
from .model import CompiledModel, compile
from .zoo import (GRAPHS, alexnet_graph, resnet18_graph, vgg16_graph,
                  vit_tiny, vit_tiny_graph)

__all__ = [
    "HurryConfig", "NetworkBuilder", "NetworkGraph", "CompiledModel",
    "compile", "GRAPHS", "alexnet_graph", "vgg16_graph",
    "resnet18_graph", "vit_tiny", "vit_tiny_graph",
]
