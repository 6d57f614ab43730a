"""Nested-dict trees of tensors — the port's stand-in for the JAX
package's pytrees of parameters, gradients and optimizer slots."""
from __future__ import annotations

from typing import Callable, List


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``: dicts recurse by key, anything else is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> List:
    """The leaves of ``tree`` in key order of its dicts."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]
