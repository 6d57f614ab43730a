"""Carry weights from a ``bigdl_tpu`` model into its port.

The JAX package's ``param_tree()`` and ``buffer_tree()`` are nested
dicts whose leaves are arrays; their keys are the port module's child,
parameter and buffer names, so a tree path joined with dots is a
``state_dict`` key.  This module takes
the tree as nested dicts of numpy arrays (``np.asarray`` of each JAX
leaf) and never imports jax.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _to_tensors(tree):
    if isinstance(tree, dict):
        return {str(k): _to_tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def load_param_tree(model, tree: Dict):
    """Copy each leaf of ``tree`` into ``model`` at the same path (cast
    to the port parameter's dtype and device).  Raises ``KeyError`` on a
    missing or extra key and ``ValueError`` on a shape mismatch."""
    return model.set_param_tree(_to_tensors(tree))


def load_buffer_tree(model, tree: Dict):
    """Copy each leaf of a JAX ``buffer_tree()`` (BatchNorm's running
    statistics) into ``model``'s buffers at the same path, with the
    checks of :func:`load_param_tree`."""
    return model.set_buffer_tree(_to_tensors(tree))


def param_tree_numpy(model) -> Dict:
    """The port model's ``param_tree()`` as nested dicts of numpy
    arrays (float32 copies on the host) — the inverse of
    :func:`load_param_tree`, for round trips."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return t.detach().to("cpu", torch.float32).numpy()

    return conv(model.param_tree())
