"""Carry the JAX package's parameters into the port.

``repro.api`` keeps a network's parameters as a pytree
``{layer: {key: array}}``; the port keeps the same nesting, keys and
layouts as a dict of torch tensors.  Given that pytree as numpy arrays
(``jax.tree.map(np.asarray, params)``), ``params_from_jax`` returns the
port's dict, so both packages compute on the same weights.

The LM stack's pytree (``repro.models.lm.init_params``) nests deeper and
stacks per-layer weights on leading axes; ``tree_from_jax`` carries any
such nesting across as it is, and so also carries the training state:
``repro.train.optimizer.init_opt_state``'s tree (float32 ``m`` / ``v``,
a 0-d int32 ``step`` that stays int32).
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


def tree_from_jax(tree, device=None, dtype: torch.dtype | None = None):
    """A nested dict of arrays -> the same nesting of tensors.

    Integer and boolean leaves keep their dtype; floating leaves keep
    theirs (a JAX bfloat16 leaf, numpy's ``ml_dtypes.bfloat16``, arrives
    bit for bit as ``torch.bfloat16``) unless ``dtype`` is given.
    """
    if isinstance(tree, dict):
        return {k: tree_from_jax(v, device, dtype) for k, v in tree.items()}
    a = np.array(tree, copy=True)
    if a.dtype.name == "bfloat16":      # torch.from_numpy cannot read it
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)
