"""ModelBroadcast (counterpart of ``bigdl_tpu/parallel/broadcast.py``;
reference models/utils/ModelBroadcast.scala:33).

The reference strips a model's weights, broadcasts skeleton and weight
arrays separately (cheaper Spark broadcast), and re-attaches them per
partition (:46-103).  Here one host skeleton is kept (the module with
its parameters and buffers on the ``meta`` device: structure and shapes,
no storage) beside the weight trees on the model's device; under a
process group the trees are rank 0's (``dist.broadcast``), so every rank
serves the same weights.  ``value()`` hands out a model bound to them.
"""
from __future__ import annotations

import copy
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.tree import tree_leaves, tree_map


def broadcast_tree_(tree, group=None):
    """Overwrite every tensor of ``tree`` in place with rank 0's (a
    no-op without a process group, or in a group of one)."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return tree
    with torch.no_grad():
        for t in tree_leaves(tree):
            dist.broadcast(t, src=0, group=group)
    return tree


class ModelBroadcast:
    def __init__(self):
        self._skeleton = None
        self._params = None
        self._buffers = None

    def broadcast(self, model) -> "ModelBroadcast":
        """Keep a storage-free skeleton of ``model`` and a copy of its
        parameter and buffer trees on its device, rank 0's under a
        process group."""
        # strip the storage before copying: the skeleton carries only
        # structure and shapes (the reference ships skeleton and weights
        # separately)
        stripped, metas = [], {}
        for m in model.modules():
            for table in (m._parameters, m._buffers):
                for name, t in table.items():
                    if t is None:
                        continue
                    if id(t) not in metas:
                        meta = torch.empty_like(t, device="meta")
                        if isinstance(t, torch.nn.Parameter):
                            meta = torch.nn.Parameter(
                                meta, requires_grad=t.requires_grad)
                        metas[id(t)] = meta
                    stripped.append((table, name, t))
                    table[name] = metas[id(t)]
        try:
            self._skeleton = copy.deepcopy(model)
        finally:
            for table, name, t in stripped:
                table[name] = t
        clone = lambda t: t.detach().clone()  # noqa: E731
        self._params = broadcast_tree_(tree_map(clone, model.param_tree()))
        self._buffers = broadcast_tree_(tree_map(clone, model.buffer_tree()))
        return self

    def value(self, device_index: Optional[int] = None):
        """A model bound to the staged weights (reference value() per
        partition), on the device they are staged on; ``device_index``
        is kept for signature parity."""
        model = copy.deepcopy(self._skeleton)
        leaves = tree_leaves(self._params) + tree_leaves(self._buffers)
        device = leaves[0].device if leaves else torch.device("cpu")
        model.to_empty(device=device)
        model._place(device)
        model.set_param_tree(self._params)
        model.set_buffer_tree(self._buffers)
        return model
