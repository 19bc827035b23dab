"""Checkpointing: atomic, resumable, elastic (mesh-shape independent).

The port of ``repro.train.checkpoint``, with its file layout: each leaf
is saved as a *logical* (unsharded) array under the JAX package's key
(``blocks/attn/wq``, ``m/blocks/mlp/w_up``, ``step``), so a checkpoint
written by either package restores in the other.

  * atomic commit: write to ``step_N.tmp/`` then rename — a preempted
    writer never corrupts the latest checkpoint.
  * the data-pipeline cursor (seed, step) is saved alongside so a
    restart skips ahead deterministically (no repeated batches).
  * ``latest_step`` scans for the newest *committed* checkpoint.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import tree_from_items, tree_items


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {key: leaf.detach().cpu().numpy()
            for key, leaf in tree_items(tree)}


def save_checkpoint(ckpt_dir: str | pathlib.Path, step: int, params: Any,
                    opt_state: Any, data_state: Optional[dict] = None):
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f"step_{step}.tmp"
    final = ckpt_dir / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    np.savez(tmp / "params.npz", **_flatten(params))
    np.savez(tmp / "opt_state.npz", **_flatten(opt_state))
    meta = {"step": step, "data_state": data_state or {}}
    (tmp / "meta.json").write_text(json.dumps(meta))
    os.replace(tmp, final)                      # atomic commit
    return final


def latest_step(ckpt_dir: str | pathlib.Path) -> Optional[int]:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
             if not p.name.endswith(".tmp") and (p / "meta.json").exists()]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str | pathlib.Path, step: int,
                       params_like: Any, opt_like: Any,
                       sharding_fn=None) -> tuple[Any, Any, dict]:
    """Restore into the structure of ``params_like`` / ``opt_like``.

    ``sharding_fn(path_key, array)`` may place each leaf (a numpy array)
    itself — the elastic-rescale hook of the JAX package.  Without it,
    each leaf goes to the device and dtype of the matching leaf of
    ``params_like`` / ``opt_like``.
    """
    ckpt_dir = pathlib.Path(ckpt_dir) / f"step_{step}"
    meta = json.loads((ckpt_dir / "meta.json").read_text())

    def rebuild(tree_like: Any, path: pathlib.Path) -> Any:
        items = {}
        with np.load(path) as flat:
            for key, like in tree_items(tree_like):
                arr = flat[key]
                if arr.shape != tuple(like.shape):
                    raise ValueError(f"{path.name}: {key} has shape "
                                     f"{arr.shape}, expected "
                                     f"{tuple(like.shape)}")
                items[key] = (sharding_fn(key, arr) if sharding_fn
                              else torch.from_numpy(arr).to(
                                  device=like.device, dtype=like.dtype))
        return tree_from_items(tree_like, items)

    return (rebuild(params_like, ckpt_dir / "params.npz"),
            rebuild(opt_like, ckpt_dir / "opt_state.npz"),
            meta["data_state"])
