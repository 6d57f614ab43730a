"""Gradient anomaly guard (counterpart of the guard half of
``bigdl_tpu/resilience/guards.py``; the loss-spike detector needs the
checkpoint rollback, which is not ported yet).

:func:`tree_finite` reduces trees of tensors to one device-side bool
"every floating leaf is finite", and :func:`where_tree` selects between
the post-update and pre-update trees under it.  A NaN/Inf step is
thereby skipped: parameters and optimizer slots come out bit-identical
to their pre-step values.  As in the JAX package this is select, not
branch: the predicate stays on the device, so the guard adds no host
sync of its own; the training loop reads it back together with the loss it
fetches anyway.
"""
from __future__ import annotations

import torch

from ..utils.tree import tree_leaves, tree_map


def tree_finite(*trees) -> torch.Tensor:
    """Scalar bool tensor: every floating leaf of every tree is finite.
    Integer leaves pass vacuously."""
    ok = None
    for tree in trees:
        for leaf in tree_leaves(tree):
            if torch.is_tensor(leaf) and leaf.is_floating_point():
                fin = torch.isfinite(leaf).all()
                ok = fin if ok is None else ok & fin
    return torch.tensor(True) if ok is None else ok


def where_tree(pred: torch.Tensor, new_tree, old_tree):
    """Leaf-wise ``torch.where(pred, new, old)`` over matching trees:
    with ``pred`` False the old state rides through untouched."""
    return tree_map(lambda n, o: torch.where(pred, n, o), new_tree, old_tree)
