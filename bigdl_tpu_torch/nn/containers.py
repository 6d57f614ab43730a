"""Containers (counterpart of ``bigdl_tpu/nn/containers.py``; reference
nn/Sequential.scala:30, Concat.scala, ConcatTable.scala,
ParallelTable.scala, MapTable.scala, Bottle.scala, Echo.scala).

Each container's ``apply_fn`` composes its children's: child ``i`` gets
``params[str(i)]``, the key it is registered under.  Children with state
(BatchNorm) keep it in their own buffers, so nothing but the output
passes between them.
"""
from __future__ import annotations

import torch

from ..utils.table import Table
from .module import AbstractModule, Container, TensorModule


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


class ParallelTable(Container):
    """Child i applied to entry i of the input Table (reference
    nn/ParallelTable.scala)."""

    def apply_fn(self, params, x):
        out = Table()
        for i, (key, m) in enumerate(self.named_children()):
            out[i + 1] = m.apply_fn(params[key], x[i + 1])
        return out


class MapTable(Container):
    """One shared child applied to every entry of the input Table
    (reference nn/MapTable.scala): one parameter tree, so the weights
    are shared."""

    def __init__(self, module: AbstractModule, device=None):
        super().__init__(module, device=device)

    def apply_fn(self, params, x):
        m = self[0]
        out = Table()
        for key in sorted(x.keys()):
            out[key] = m.apply_fn(params["0"], x[key])
        return out


class Bottle(Container):
    """Fold the leading dims into one, apply the child, unfold them
    (reference nn/Bottle.scala)."""

    def __init__(self, module: AbstractModule, n_input_dim: int = 2,
                 n_output_dim: int = 2, device=None):
        super().__init__(module, device=device)
        self.n_input_dim = n_input_dim
        self.n_output_dim = n_output_dim

    def apply_fn(self, params, x):
        if x.dim() <= self.n_input_dim:
            return self[0].apply_fn(params["0"], x)
        cut = x.dim() - self.n_input_dim + 1
        out = self[0].apply_fn(params["0"],
                               x.reshape((-1,) + tuple(x.shape[cut:])))
        return out.reshape(tuple(x.shape[:cut]) + tuple(out.shape[1:]))


class Echo(TensorModule):
    """Print the shape of the activations that pass (reference
    nn/Echo.scala); the identity."""

    def _compute(self, params, x):
        print(f"{self.get_name()} shape: {tuple(x.shape)}")
        return x
