"""Elementwise reductions of a Table's entries 1..n (counterpart of
``bigdl_tpu/nn/table_ops.py``; reference nn/CAddTable.scala,
CSubTable.scala, CMulTable.scala, CDivTable.scala, CMaxTable.scala,
CMinTable.scala)."""
from __future__ import annotations

import torch

from .module import AbstractModule


class _TableReduce(AbstractModule):
    def _reduce(self, a, b):
        raise NotImplementedError

    def _compute(self, params, x):
        out = x[1]
        for i in range(2, x.length() + 1):
            out = self._reduce(out, x[i])
        return out


class CAddTable(_TableReduce):
    """``inplace`` is accepted for the reference's signature; the sum is
    a new tensor, as in the JAX layer."""

    def __init__(self, inplace: bool = False, device=None):
        super().__init__(device)

    def _reduce(self, a, b):
        return a + b


class CSubTable(_TableReduce):
    def _reduce(self, a, b):
        return a - b


class CMulTable(_TableReduce):
    def _reduce(self, a, b):
        return a * b


class CDivTable(_TableReduce):
    def _reduce(self, a, b):
        return a / b


class CMaxTable(_TableReduce):
    def _reduce(self, a, b):
        return torch.maximum(a, b)


class CMinTable(_TableReduce):
    def _reduce(self, a, b):
        return torch.minimum(a, b)
