"""Linear, LookupTable and MulConstant (counterpart of
``bigdl_tpu/nn/linear.py``; the other layers of that module are not
ported yet)."""
from __future__ import annotations

from typing import Optional

import torch

from ..device import DeviceLike
from .initialization import IN_OUT, ONE_D, RandomNormal, RandomUniform
from .module import TensorModule


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x W^T + b in the weight's dtype.  The JAX layer accumulates
    f32/bf16 products in f32 and casts the sum to the weight dtype;
    a float32 or bfloat16 matmul does the same here (cuBLAS computes
    bf16 GEMMs with an f32 accumulator)."""
    y = torch.matmul(x.to(weight.dtype), weight.t())
    return y + bias if bias is not None else y


class Linear(TensorModule):
    """y = x W^T + b (reference nn/Linear.scala:44)."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device)
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias
        self._register_param("weight", RandomUniform().init(
            (output_size, input_size), IN_OUT, generator))
        if with_bias:
            self._register_param("bias", RandomUniform().init(
                (output_size,), ONE_D, generator))

    def _compute(self, params, x):
        return linear(x, params["weight"],
                      params["bias"] if self.with_bias else None)


def lookup(ids: torch.Tensor, weight: torch.Tensor,
           padding_value: int = 0) -> torch.Tensor:
    """Rows of ``weight`` at 1-based ``ids`` (Torch convention).
    Out-of-range ids are clamped into [1, n_index], as the JAX layer's
    ``jnp.take`` of a clipped index does; ``padding_value`` rows are
    zeroed when it is non-zero."""
    idx = ids.to(torch.int64) - 1
    out = weight[idx.clamp(0, weight.shape[0] - 1)]
    if padding_value != 0:
        mask = ids.to(torch.int64) == int(padding_value)
        out = out.masked_fill(mask[..., None], 0.0)
    return out


class LookupTable(TensorModule):
    """Embedding over 1-based ids (reference nn/LookupTable.scala)."""

    def __init__(self, n_index: int, n_output: int, padding_value: float = 0,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device)
        self.n_index, self.n_output = n_index, n_output
        self.padding_value = padding_value
        self._register_param("weight", RandomNormal(0, 1).init(
            (n_index, n_output), ONE_D, generator))

    def _compute(self, params, x):
        return lookup(x, params["weight"], self.padding_value)


class MulConstant(TensorModule):
    """x times a fixed scalar (reference nn/MulConstant.scala).
    ``inplace`` is accepted for the reference's signature."""

    def __init__(self, constant_scalar: float, inplace: bool = False,
                 device: DeviceLike = None):
        super().__init__(device)
        self.constant_scalar = constant_scalar

    def _compute(self, params, x):
        return x * self.constant_scalar
