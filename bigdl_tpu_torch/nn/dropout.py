"""Dropout (counterpart of ``bigdl_tpu/nn/dropout.py``; reference
nn/Dropout.scala:44).

The mask is drawn from the forward's generator (``nn/module.py``: the
training step's, or the one a verbs ``forward`` seeds from the host
stream), so ``backward`` — over the forward's graph or a replay under
the same generator state — applies the forward's mask.
"""
from __future__ import annotations

import torch

from .module import TensorModule, current_generator


def dropout(x: torch.Tensor, p: float, generator: torch.Generator,
            scale: bool = True) -> torch.Tensor:
    """x times a mask of Bernoulli(1 - p) draws from ``generator`` (times
    1 / (1 - p) when ``scale``).  The mask is drawn as bools, one byte an
    element; the product saves only it for the backward, and the scale
    is applied in place, so a mask costs one pass to draw and two over
    x's size."""
    keep = 1.0 - p
    mask = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    mask.bernoulli_(keep, generator=generator)
    out = x * mask
    return out.mul_(1.0 / keep) if scale else out


class Dropout(TensorModule):
    """Zero each element with probability ``init_p`` in training and
    scale the kept ones by 1 / (1 - p) when ``scale``; the identity in
    eval.  ``inplace`` is accepted for the reference's signature."""

    def __init__(self, init_p: float = 0.5, inplace: bool = False,
                 scale: bool = True, device=None):
        super().__init__(device)
        self.p = init_p
        self.scale = scale

    def set_p(self, p: float):
        self.p = p
        return self

    def _compute(self, params, x):
        if not self.training or self.p <= 0.0:
            return x
        return dropout(x, self.p, current_generator(x.device), self.scale)
