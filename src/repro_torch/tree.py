"""Nested dicts of tensors: the port's counterpart of a JAX pytree.

The LM stack and the training path keep parameters, optimizer state and
batches as nested dicts whose leaves are tensors.  ``tree_items`` walks
such a tree in ``jax.tree_util``'s order (dict keys sorted at every
level) and names each leaf by its keys joined with ``/``, as the JAX
package's checkpoint does (``blocks/attn/wq``), so sums over leaves and
checkpoint files agree with the JAX package's.
"""

from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``; the result keeps ``tree``'s nesting and key order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_items(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs in ``jax.tree_util`` order: sorted keys."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_items(tree[k], f"{prefix}/{k}" if prefix else str(k))
        return out
    return [(prefix, tree)]


def tree_leaves(tree: Any) -> list:
    """The leaves in ``jax.tree.leaves`` order."""
    return [leaf for _, leaf in tree_items(tree)]


def tree_from_items(like: Any, items: dict[str, Any],
                    prefix: str = "") -> Any:
    """``like``'s nesting and key order with the leaf at each path taken
    from ``items`` (keyed as ``tree_items`` names them).

    Module-level recursion: a nested recursive function would hold
    ``items`` in a reference cycle, keeping every leaf (a whole step's
    gradients) alive until the garbage collector runs.
    """
    if isinstance(like, dict):
        return {k: tree_from_items(v, items,
                                   f"{prefix}/{k}" if prefix else str(k))
                for k, v in like.items()}
    return items[prefix]
