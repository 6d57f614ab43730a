"""Activations (counterpart of ``bigdl_tpu/nn/activations.py``; reference
nn/ReLU.scala and the other elementwise layers, SURVEY §2.4).

Plain PyTorch, op for op the JAX layers' ``jnp`` formulas; no Pallas
kernel computes them.  RReLU draws its training slopes from the
forward's generator (``nn/module.py``), so ``backward`` sees the
forward's slopes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .initialization import ONE_D, ConstInitMethod
from .module import TensorModule, current_generator


class ReLU(TensorModule):
    """reference nn/ReLU.scala.  ``ip`` (in place) is accepted for the
    reference's signature; the output is a new tensor, as in the JAX
    layer, since autograd needs the input."""

    def __init__(self, ip: bool = False, device=None):
        super().__init__(device)

    def _compute(self, params, x):
        return torch.relu(x)


class ReLU6(TensorModule):
    def _compute(self, params, x):
        return torch.clamp(x, 0.0, 6.0)


class LeakyReLU(TensorModule):
    def __init__(self, negval: float = 0.01, inplace: bool = False,
                 device=None):
        super().__init__(device)
        self.negval = negval

    def _compute(self, params, x):
        return torch.where(x > 0, x, self.negval * x)


class PReLU(TensorModule):
    """Learned negative slope (reference nn/PReLU.scala);
    ``n_output_plane`` 0 → one shared scalar.  The channel axis is 1 for
    an even rank (NC, NCHW) and 0 for an odd one (C, CHW),
    PReLU.scala:86."""

    def __init__(self, n_output_plane: int = 0, device=None):
        super().__init__(device)
        self.n_output_plane = n_output_plane
        init = ConstInitMethod(0.25)
        self._register_param("weight", init.init(
            (max(n_output_plane, 1),), ONE_D), init, ONE_D)

    def _compute(self, params, x):
        w = params["weight"]
        if self.n_output_plane > 0:
            shape = [1] * x.dim()
            shape[(x.dim() + 1) % 2] = self.n_output_plane
            w = w.reshape(shape)
        return torch.where(x > 0, x, w * x)


class RReLU(TensorModule):
    """Randomized leaky ReLU (reference nn/RReLU.scala): in training
    each element's slope ~ U(lower, upper), drawn from the forward's
    generator; in eval the fixed (lower + upper) / 2."""

    def __init__(self, lower: float = 1.0 / 8, upper: float = 1.0 / 3,
                 inplace: bool = False, device=None):
        super().__init__(device)
        self.lower, self.upper = lower, upper

    def _compute(self, params, x):
        if self.training:
            g = current_generator(x.device)
            a = torch.empty(x.shape, dtype=x.dtype, device=x.device)
            a.uniform_(self.lower, self.upper, generator=g)
        else:
            a = (self.lower + self.upper) / 2.0
        return torch.where(x >= 0, x, a * x)


class ELU(TensorModule):
    def __init__(self, alpha: float = 1.0, inplace: bool = False,
                 device=None):
        super().__init__(device)
        self.alpha = alpha

    def _compute(self, params, x):
        return torch.where(x > 0, x, self.alpha * torch.expm1(x))


class Tanh(TensorModule):
    def _compute(self, params, x):
        return torch.tanh(x)


class Sigmoid(TensorModule):
    def _compute(self, params, x):
        return torch.sigmoid(x)


class LogSigmoid(TensorModule):
    def _compute(self, params, x):
        return F.logsigmoid(x)


class LogSoftMax(TensorModule):
    """reference nn/LogSoftMax.scala — over the last dim."""

    def _compute(self, params, x):
        return torch.log_softmax(x, dim=-1)


def _softmax_axis(x) -> int:
    """dim 1 of a batch (rank 2 or 4), dim 0 of one sample (rank 1 or
    3), else the last (reference SoftMax.scala)."""
    return 1 if x.dim() in (2, 4) else 0 if x.dim() in (1, 3) else -1


class SoftMax(TensorModule):
    def _compute(self, params, x):
        return torch.softmax(x, dim=_softmax_axis(x))


class SoftMin(TensorModule):
    def _compute(self, params, x):
        return torch.softmax(-x, dim=_softmax_axis(x))


class SoftPlus(TensorModule):
    """log(1 + exp(beta x)) / beta, x itself above beta x = 20 as
    torch's threshold."""

    def __init__(self, beta: float = 1.0, device=None):
        super().__init__(device)
        self.beta = beta

    def _compute(self, params, x):
        bx = self.beta * x
        return torch.where(bx > 20.0, x, torch.log1p(torch.exp(bx))
                           / self.beta)


class SoftSign(TensorModule):
    def _compute(self, params, x):
        return x / (1.0 + x.abs())


class HardTanh(TensorModule):
    def __init__(self, min_value: float = -1.0, max_value: float = 1.0,
                 inplace: bool = False, device=None):
        super().__init__(device)
        assert max_value > min_value
        self.min_value, self.max_value = min_value, max_value

    def _compute(self, params, x):
        return torch.clamp(x, self.min_value, self.max_value)


class HardShrink(TensorModule):
    def __init__(self, lambd: float = 0.5, device=None):
        super().__init__(device)
        self.lambd = lambd

    def _compute(self, params, x):
        return torch.where(x.abs() > self.lambd, x, torch.zeros_like(x))


class SoftShrink(TensorModule):
    def __init__(self, lambd: float = 0.5, device=None):
        super().__init__(device)
        self.lambd = lambd

    def _compute(self, params, x):
        zero = torch.zeros_like(x)
        return torch.where(x > self.lambd, x - self.lambd,
                           torch.where(x < -self.lambd, x + self.lambd, zero))


class TanhShrink(TensorModule):
    def _compute(self, params, x):
        return x - torch.tanh(x)


class Threshold(TensorModule):
    def __init__(self, th: float = 1e-6, v: float = 0.0, ip: bool = False,
                 device=None):
        super().__init__(device)
        self.th, self.v = th, v

    def _compute(self, params, x):
        return torch.where(x > self.th, x, torch.full_like(x, self.v))


class Clamp(HardTanh):
    def __init__(self, min_value: float, max_value: float, device=None):
        super().__init__(float(min_value), float(max_value), device=device)


class Abs(TensorModule):
    def _compute(self, params, x):
        return x.abs()


class Power(TensorModule):
    """(shift + scale * x) ^ power (reference nn/Power.scala)."""

    def __init__(self, power: float, scale: float = 1.0, shift: float = 0.0,
                 device=None):
        super().__init__(device)
        self.power, self.scale, self.shift = power, scale, shift

    def _compute(self, params, x):
        return torch.pow(self.shift + self.scale * x, self.power)


class Square(TensorModule):
    def _compute(self, params, x):
        return torch.square(x)


class Sqrt(TensorModule):
    def _compute(self, params, x):
        return torch.sqrt(x)


class Log(TensorModule):
    def _compute(self, params, x):
        return torch.log(x)


class Exp(TensorModule):
    def _compute(self, params, x):
        return torch.exp(x)


def _batch_axis(dim: int, n_input_dims: int, x) -> int:
    """The 0-based axis of 1-based ``dim``, one further in batch mode
    (more dims than ``n_input_dims``)."""
    d = dim - 1
    if n_input_dims > 0 and x.dim() > n_input_dims:
        d += 1
    return d


class Mean(TensorModule):
    """Mean over a 1-based dim (reference nn/Mean.scala)."""

    def __init__(self, dimension: int = 1, n_input_dims: int = -1,
                 squeeze: bool = True, device=None):
        super().__init__(device)
        self.dimension = dimension
        self.n_input_dims = n_input_dims
        self.squeeze = squeeze

    def _compute(self, params, x):
        return x.mean(dim=_batch_axis(self.dimension, self.n_input_dims, x),
                      keepdim=not self.squeeze)


class Sum(TensorModule):
    """Sum over a 1-based dim (reference nn/Sum.scala:44): a negative dim
    counts from the end, ``n_input_dims`` marks batch mode (one more
    leading dim shifts the axis), ``size_average`` divides by the
    reduced extent, ``squeeze`` drops the reduced dim.  The reference
    resolves a negative dim and then applies the batch shift; where the
    two run past the rank it raises, and so does this layer."""

    def __init__(self, dimension: int = 1, n_input_dims: int = -1,
                 size_average: bool = False, squeeze: bool = True,
                 device=None):
        super().__init__(device)
        self.dimension = dimension
        self.n_input_dims = n_input_dims
        self.size_average = size_average
        self.squeeze = squeeze

    def _axis(self, x) -> int:
        d = self.dimension
        if d < 0:
            d = x.dim() + d + 1
        if self.n_input_dims > 0 and x.dim() == self.n_input_dims + 1:
            d += 1
        if not 1 <= d <= x.dim():
            raise ValueError(
                f"Sum dimension {self.dimension} exceeds input rank {x.dim()}")
        return d - 1

    def _compute(self, params, x):
        axis = self._axis(x)
        y = x.sum(dim=axis, keepdim=not (self.squeeze and x.dim() > 1))
        return y / x.shape[axis] if self.size_average else y


class Max(TensorModule):
    def __init__(self, dim: int = 1, num_input_dims: int = -1, device=None):
        super().__init__(device)
        self.dim, self.num_input_dims = dim, num_input_dims

    def _compute(self, params, x):
        return x.amax(dim=_batch_axis(self.dim, self.num_input_dims, x))


class Min(TensorModule):
    def __init__(self, dim: int = 1, num_input_dims: int = -1, device=None):
        super().__init__(device)
        self.dim, self.num_input_dims = dim, num_input_dims

    def _compute(self, params, x):
        return x.amin(dim=_batch_axis(self.dim, self.num_input_dims, x))
