"""Table reductions (counterpart of ``bigdl_tpu/nn/table_ops.py``, trimmed
to ``CAddTable``; reference nn/CAddTable.scala)."""
from __future__ import annotations

from .module import AbstractModule


class CAddTable(AbstractModule):
    """The sum of a Table's entries 1..n.  ``inplace`` is accepted for
    the reference's signature; the sum is a new tensor, as in the JAX
    layer."""

    def __init__(self, inplace: bool = False, device=None):
        super().__init__(device)

    def _compute(self, params, x):
        out = x[1]
        for i in range(2, x.length() + 1):
            out = out + x[i]
        return out
