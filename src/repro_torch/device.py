"""Where the port runs: the GPU unless the caller names another device."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``"cuda"``.

    Raises when a CUDA device is asked for and none is present: the
    port never carries on on the CPU unless told to.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA GPU and none is available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return dev
