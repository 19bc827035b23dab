"""A dispatch mode that holds code to what a CUDA graph can capture, on
the ``meta`` device, for the port's CPU tests
(``test_torch_executable.py``, ``test_torch_decode_executable.py``).
"""

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

# ops that read a value back to the host or size their output by the data
SYNC_OPS = {"_local_scalar_dense", "nonzero", "masked_select", "item"}


class CaptureSafety(TorchDispatchMode):
    """Fails on an op a CUDA graph cannot capture: a value read to the
    host, an output sized by the data, or a tensor on the CPU (a copy
    to or from the host).  ``paused`` skips the kernels' plain versions,
    which the card does not run."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.paused:
            self.ops += 1
            name = func.overloadpacket.__name__
            if name in SYNC_OPS or "unique" in name:
                raise AssertionError(f"{func} cannot be captured")
            _on_the_device(func, (args, kwargs))
        out = func(*args, **kwargs)
        if not self.paused:
            _on_the_device(func, out)
        return out


def _on_the_device(func, tree) -> None:
    for leaf in pytree.tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.device
        if isinstance(leaf, torch.device) and leaf.type == "cpu":
            raise AssertionError(f"{func} moves data to or from the CPU")
