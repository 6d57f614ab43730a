"""Containers (counterpart of ``bigdl_tpu/nn/containers.py``, trimmed to
what the conv slice's models use: ``Sequential``, ``Concat``,
``ConcatTable`` and ``Identity``; reference nn/Sequential.scala:30,
Concat.scala, ConcatTable.scala).

Each container's ``apply_fn`` composes its children's: child ``i`` gets
``params[str(i)]``, the key it is registered under.  Children with state
(BatchNorm) keep it in their own buffers, so nothing but the output
passes between them.
"""
from __future__ import annotations

import torch

from ..utils.table import Table
from .module import Container, TensorModule


class Sequential(Container):
    """Chain children (reference nn/Sequential.scala:30)."""

    def apply_fn(self, params, x):
        for key, m in self.named_children():
            x = m.apply_fn(params[key], x)
        return x


class Concat(Container):
    """Apply each child to the same input and concatenate the outputs
    along ``dimension`` (1-based; reference nn/Concat.scala)."""

    def __init__(self, dimension: int, *modules, device=None):
        super().__init__(*modules, device=device)
        self.dimension = dimension

    def apply_fn(self, params, x):
        outs = [m.apply_fn(params[key], x)
                for key, m in self.named_children()]
        return torch.cat(outs, dim=self.dimension - 1)


class ConcatTable(Container):
    """Apply each child to the same input; the outputs in a 1-based
    ``Table`` (reference nn/ConcatTable.scala)."""

    def apply_fn(self, params, x):
        out = Table()
        for i, (key, m) in enumerate(self.named_children()):
            out[i + 1] = m.apply_fn(params[key], x)
        return out


class Identity(TensorModule):
    """reference nn/Identity.scala"""

    def _compute(self, params, x):
        return x
