"""Shape and structure layers (counterpart of ``bigdl_tpu/nn/shape_ops.py``;
reference nn/Reshape.scala and the other layout layers, SURVEY §2.4).

Plain PyTorch.  ``Transpose``, ``Narrow``, ``Select``, ``SplitTable``'s
entries and ``Squeeze``/``Unsqueeze``/``Reshape``/``View`` of a
contiguous input are views of their input, not copies: a kernel that
takes strided operands (K4 over a column slice, K1-K3 over a
head-strided layout) reads them in place.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..utils.table import Table
from .module import AbstractModule, TensorModule


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
        self.num_input_dims = 0

    def set_num_input_dims(self, n: int):
        self.num_input_dims = n
        return self

    def _compute(self, params, x):
        known = math.prod(s for s in self.sizes if s != -1)
        if -1 in self.sizes:
            return x.reshape(self.sizes)
        if x.numel() == known:
            return x.reshape(self.sizes)
        return x.reshape((-1,) + self.sizes)


class InferReshape(TensorModule):
    """reference nn/InferReshape.scala — 0 keeps the input's dim, -1 is
    inferred."""

    def __init__(self, size: Sequence[int], batch_mode: bool = False,
                 device=None):
        super().__init__(device)
        self.size = tuple(size)
        self.batch_mode = batch_mode

    def _compute(self, params, x):
        in_shape = x.shape[1:] if self.batch_mode else x.shape
        out = tuple(in_shape[i] if s == 0 else s
                    for i, s in enumerate(self.size))
        if self.batch_mode:
            return x.reshape((x.shape[0],) + out)
        return x.reshape(out)


class Transpose(TensorModule):
    """A sequence of 1-based dim swaps (reference nn/Transpose.scala); the
    output is a view of the input."""

    def __init__(self, permutations: Sequence, device=None):
        super().__init__(device)
        self.permutations = [tuple(p) for p in permutations]

    def _compute(self, params, x):
        perm = list(range(x.dim()))
        for d1, d2 in self.permutations:
            perm[d1 - 1], perm[d2 - 1] = perm[d2 - 1], perm[d1 - 1]
        return x.permute(perm)


class Replicate(TensorModule):
    """Insert a new dim and repeat along it (reference
    nn/Replicate.scala); ``n_dim`` marks batch mode."""

    def __init__(self, n_features: int, dim: int = 1,
                 n_dim: int = 2 ** 31 - 1, device=None):
        super().__init__(device)
        self.n_features, self.dim, self.n_dim = n_features, dim, n_dim

    def _compute(self, params, x):
        d = self.dim - 1
        if x.dim() > self.n_dim:
            d += 1
        y = x.unsqueeze(d)
        shape = list(y.shape)
        shape[d] = self.n_features
        return y.expand(shape)


class Squeeze(TensorModule):
    def __init__(self, dim: Optional[int] = None, num_input_dims: int = -1,
                 device=None):
        super().__init__(device)
        self.dim, self.num_input_dims = dim, num_input_dims

    def _compute(self, params, x):
        if self.dim is None:
            return x.squeeze()
        d = self.dim - 1
        if self.num_input_dims > 0 and x.dim() > self.num_input_dims:
            d += 1
        return x.squeeze(d) if x.shape[d] == 1 else x


class Unsqueeze(TensorModule):
    def __init__(self, pos: int, num_input_dims: int = -1, device=None):
        super().__init__(device)
        self.pos, self.num_input_dims = pos, num_input_dims

    def _compute(self, params, x):
        d = self.pos - 1
        if self.num_input_dims > 0 and x.dim() > self.num_input_dims:
            d += 1
        return x.unsqueeze(d)


def _dim0(dimension: int, ndim: int) -> int:
    """0-based axis of a 1-based dim; a negative one counts from the end."""
    return dimension - 1 if dimension > 0 else ndim + dimension


class Select(TensorModule):
    """1-based select along a dim, negative counting from the end
    (reference nn/Select.scala); a view of the input."""

    def __init__(self, dimension: int, index: int, device=None):
        super().__init__(device)
        self.dimension, self.index = dimension, index

    def _compute(self, params, x):
        d = _dim0(self.dimension, x.dim())
        i = self.index - 1 if self.index > 0 else x.shape[d] + self.index
        return x.select(d, i)


class Narrow(TensorModule):
    """1-based narrow (reference nn/Narrow.scala); a negative length keeps
    all but |length| - 1 trailing entries.  A view of the input."""

    def __init__(self, dimension: int, offset: int, length: int = 1,
                 device=None):
        super().__init__(device)
        self.dimension, self.offset, self.length = dimension, offset, length

    def _compute(self, params, x):
        d = _dim0(self.dimension, x.dim())
        length = self.length
        if length < 0:
            length = x.shape[d] - self.offset + 2 + length
        return x.narrow(d, self.offset - 1, length)


class SelectTable(AbstractModule):
    """Entry ``index`` of a Table (reference nn/SelectTable.scala)."""

    def __init__(self, index: int, device=None):
        super().__init__(device)
        self.index = index

    def _compute(self, params, inp):
        idx = self.index if self.index > 0 else len(inp) + self.index + 1
        return inp[idx]


class NarrowTable(AbstractModule):
    """A slice of a Table (reference nn/NarrowTable.scala)."""

    def __init__(self, offset: int, length: int = 1, device=None):
        super().__init__(device)
        self.offset, self.length = offset, length

    def _compute(self, params, inp):
        length = self.length
        if length < 0:
            length = inp.length() - self.offset + 2 + length
        out = Table()
        for i in range(length):
            out[i + 1] = inp[self.offset + i]
        return out


class FlattenTable(AbstractModule):
    """reference nn/FlattenTable.scala"""

    def _compute(self, params, inp):
        return inp.flatten()


class SplitTable(AbstractModule):
    """A tensor split along a dim into a Table of views (reference
    nn/SplitTable.scala)."""

    def __init__(self, dimension: int, n_input_dims: int = -1, device=None):
        super().__init__(device)
        self.dimension, self.n_input_dims = dimension, n_input_dims

    def _compute(self, params, x):
        d = _dim0(self.dimension, x.dim())
        if self.n_input_dims > 0 and x.dim() > self.n_input_dims:
            d += 1
        return Table(*x.unbind(d))


class JoinTable(AbstractModule):
    """A Table of tensors concatenated along a dim (reference
    nn/JoinTable.scala)."""

    def __init__(self, dimension: int, n_input_dims: int = -1, device=None):
        super().__init__(device)
        self.dimension, self.n_input_dims = dimension, n_input_dims

    def _compute(self, params, inp):
        d = self.dimension - 1
        if self.n_input_dims > 0 and inp[1].dim() > self.n_input_dims:
            d += 1
        return torch.cat([inp[i + 1] for i in range(inp.length())], dim=d)


class Pack(AbstractModule):
    """A Table of tensors stacked along a new dim (reference
    nn/Pack.scala)."""

    def __init__(self, dimension: int, device=None):
        super().__init__(device)
        self.dimension = dimension

    def _compute(self, params, inp):
        arrs = ([inp[i + 1] for i in range(inp.length())]
                if isinstance(inp, Table) else [inp])
        return torch.stack(arrs, dim=self.dimension - 1)


class Reverse(TensorModule):
    """Reverse along a dim (reference nn/Reverse.scala)."""

    def __init__(self, dimension: int = 1, device=None):
        super().__init__(device)
        self.dimension = dimension

    def _compute(self, params, x):
        return torch.flip(x, dims=(self.dimension - 1,))


class Contiguous(TensorModule):
    """reference nn/Contiguous.scala: a contiguous copy where the input
    is not contiguous."""

    def _compute(self, params, x):
        return x.contiguous()


class Index(AbstractModule):
    """Table(src, 1-based indices) → index_select along a dim (reference
    nn/Index.scala)."""

    def __init__(self, dimension: int, device=None):
        super().__init__(device)
        self.dimension = dimension

    def _compute(self, params, inp):
        src, idx = inp[1], inp[2]
        return src.index_select(self.dimension - 1,
                                idx.to(torch.int64).reshape(-1) - 1
                                ).reshape(src.shape[:self.dimension - 1]
                                          + idx.shape
                                          + src.shape[self.dimension:])


class MaskedSelect(AbstractModule):
    """Table(src, mask) → the masked entries, flat (reference
    nn/MaskedSelect.scala); the mask's gradient is zero."""

    def _compute(self, params, inp):
        return torch.masked_select(inp[1], inp[2].to(torch.bool))


class Padding(TensorModule):
    """Pad ``|pad|`` entries of ``value`` before (pad < 0) or after a dim
    (reference nn/Padding.scala)."""

    def __init__(self, dim: int, pad: int, n_input_dim: int,
                 value: float = 0.0, n_index: int = 1, device=None):
        super().__init__(device)
        self.dim, self.pad, self.n_input_dim = dim, pad, n_input_dim
        self.value = value

    def _compute(self, params, x):
        d = self.dim - 1
        if x.dim() > self.n_input_dim:
            d += 1
        side = (abs(self.pad), 0) if self.pad < 0 else (0, self.pad)
        return F.pad(x, (0, 0) * (x.dim() - 1 - d) + side,
                     value=self.value)


class SpatialZeroPadding(TensorModule):
    """reference nn/SpatialZeroPadding.scala — NCHW zero pad."""

    def __init__(self, pad_left: int, pad_right: int, pad_top: int,
                 pad_bottom: int, device=None):
        super().__init__(device)
        self.pads = (pad_left, pad_right, pad_top, pad_bottom)

    def _compute(self, params, x):
        return F.pad(x, self.pads)


class DotProduct(AbstractModule):
    """Row-wise dot product of Table(a, b) (reference
    nn/DotProduct.scala)."""

    def _compute(self, params, inp):
        return (inp[1] * inp[2]).sum(dim=-1)


class CosineDistance(AbstractModule):
    """Row-wise cosine of Table(a, b) (reference
    nn/CosineDistance.scala)."""

    def _compute(self, params, inp):
        a, b = inp[1], inp[2]
        na = torch.linalg.vector_norm(a, dim=-1).clamp_min(1e-12)
        nb = torch.linalg.vector_norm(b, dim=-1).clamp_min(1e-12)
        return (a * b).sum(dim=-1) / (na * nb)


class PairwiseDistance(AbstractModule):
    """The Lp distance of Table(a, b) (reference
    nn/PairwiseDistance.scala)."""

    def __init__(self, norm: int = 2, device=None):
        super().__init__(device)
        self.norm = norm

    def _compute(self, params, inp):
        d = inp[1] - inp[2]
        return (d.abs() ** self.norm).sum(dim=-1) ** (1.0 / self.norm)


class MixtureTable(AbstractModule):
    """Gater-weighted blend of expert outputs (reference
    nn/MixtureTable.scala): Table(gater (N, K), experts — a Table of K
    tensors (N, ...) or one (N, K, ...) tensor)."""

    def __init__(self, dim: int = 2 ** 31 - 1, device=None):
        super().__init__(device)
        self.dim = dim

    def _compute(self, params, inp):
        gater, experts = inp[1], inp[2]
        stacked = (torch.stack([experts[i + 1]
                                for i in range(experts.length())], dim=1)
                   if isinstance(experts, Table) else experts)
        g = gater.reshape(tuple(gater.shape)
                          + (1,) * (stacked.dim() - gater.dim()))
        return (stacked * g).sum(dim=1)


class Scale(TensorModule):
    """CMul then CAdd (reference nn/Scale.scala); children ``"mul"`` and
    ``"add"``, the JAX layer's ``param_tree`` keys."""

    def __init__(self, size: Sequence[int], device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device)
        from .linear import CAdd, CMul

        self.add_module("mul", CMul(size, device=device, generator=generator))
        self.add_module("add", CAdd(size, device=device, generator=generator))

    def _compute(self, params, x):
        y = self._modules["mul"].apply_fn(params["mul"], x)
        return self._modules["add"].apply_fn(params["add"], y)

    def gradient_scale_tree(self):
        # the children's scales, as the JAX layer (shape_ops.py:410-412)
        return {k: m.gradient_scale_tree() for k, m in self.named_children()}


class _Reverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lam: float):
        ctx.lam = lam
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.lam * g, None


class GradientReversal(TensorModule):
    """Identity forward, gradient times -lambda (reference
    nn/GradientReversal.scala)."""

    def __init__(self, the_lambda: float = 1.0, device=None):
        super().__init__(device)
        self.the_lambda = the_lambda

    def set_lambda(self, lam: float):
        self.the_lambda = lam
        return self

    def _compute(self, params, x):
        return _Reverse.apply(x, float(self.the_lambda))
