"""Shape layers (counterpart of ``bigdl_tpu/nn/shape_ops.py``, trimmed to
``Reshape`` and ``View``)."""
from __future__ import annotations

import math
from typing import Optional, Sequence

from .module import TensorModule


class Reshape(TensorModule):
    """reference nn/Reshape.scala — ``batch_mode`` None auto-detects: the
    leading dim is kept as a batch dim unless the input has exactly
    ``prod(size)`` elements and a leading dim other than 1 (Reshape.scala
    :53-66, as the JAX layer reads it)."""

    def __init__(self, size: Sequence[int], batch_mode: Optional[bool] = None,
                 device=None):
        super().__init__(device)
        self.size = tuple(size)
        self.batch_mode = batch_mode
        self.n_element = math.prod(self.size)

    def _compute(self, params, x):
        if self.batch_mode is False or (
                self.batch_mode is None and x.numel() == self.n_element
                and x.shape[0] != 1):
            return x.reshape(self.size)
        return x.reshape((x.shape[0],) + self.size)


class View(TensorModule):
    """reference nn/View.scala — a ``-1`` wildcard is allowed; an input
    with more elements than ``prod(sizes)`` gets a leading batch dim."""

    def __init__(self, *sizes, device=None):
        super().__init__(device)
        if len(sizes) == 1 and isinstance(sizes[0], (tuple, list)):
            sizes = tuple(sizes[0])
        self.sizes = tuple(sizes)

    def _compute(self, params, x):
        known = math.prod(s for s in self.sizes if s != -1)
        if -1 in self.sizes:
            return x.reshape(self.sizes)
        if x.numel() == known:
            return x.reshape(self.sizes)
        return x.reshape((-1,) + self.sizes)
