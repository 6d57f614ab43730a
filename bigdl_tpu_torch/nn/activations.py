"""Activations (counterpart of ``bigdl_tpu/nn/activations.py``, trimmed to
``ReLU``, ``Tanh`` and ``LogSoftMax``)."""
from __future__ import annotations

import torch

from .module import TensorModule


class ReLU(TensorModule):
    """reference nn/ReLU.scala.  ``ip`` (in place) is accepted for the
    reference's signature; the output is a new tensor, as in the JAX
    layer, since autograd needs the input."""

    def __init__(self, ip: bool = False, device=None):
        super().__init__(device)

    def _compute(self, params, x):
        return torch.relu(x)


class Tanh(TensorModule):
    def _compute(self, params, x):
        return torch.tanh(x)


class LogSoftMax(TensorModule):
    """reference nn/LogSoftMax.scala — over the last dim."""

    def _compute(self, params, x):
        return torch.log_softmax(x, dim=-1)
