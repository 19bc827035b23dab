"""Carry the JAX package's parameters into the port.

``repro.api`` keeps a network's parameters as a pytree
``{layer: {key: array}}``; the port keeps the same nesting, keys and
layouts as a dict of torch tensors.  Given that pytree as numpy arrays
(``jax.tree.map(np.asarray, params)``), ``params_from_jax`` returns the
port's dict, so both packages compute on the same weights.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree: dict, device=None
                    ) -> dict[str, dict[str, torch.Tensor]]:
    """``{layer: {key: array}}`` -> ``{layer: {key: float32 tensor}}``."""
    return {layer: {key: torch.from_numpy(
                np.array(arr, dtype=np.float32, copy=True)).to(device)
            for key, arr in p.items()}
            for layer, p in tree.items()}
