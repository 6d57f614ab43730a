"""AbstractModule — the layer protocol over ``torch.nn.Module``
(counterpart of ``bigdl_tpu/nn/module.py``, trimmed to what the serving
and training paths use).

The JAX package computes every layer as one pure function of an
explicit parameter tree.  The port keeps that shape:

    apply_fn(params, x) -> output

where ``params`` is a nested dict of tensors with the JAX package's
keys (``param_tree()``), and ``forward(x)`` is
``apply_fn(self.param_tree(), x)``.  Subclasses implement
``_compute(params, x)`` — the JAX package's ``_apply``; the name
differs because ``torch.nn.Module._apply`` is PyTorch's own hook that
``.to()`` and ``.cuda()`` run through.  Likewise the JAX package's
``training()`` verb is ``train()`` here: ``training`` is the mode flag
of every ``torch.nn.Module``.

Parameters and children are registered under the JAX package's keys
(``"weight"``, ``"wq"``, ``"pos"``, children ``"0"``, ``"1"``, …), so a
``state_dict`` key is the JAX ``param_tree()`` path joined with dots.

State (the JAX package's buffer tree, BatchNorm's running statistics)
lives in torch buffers under the JAX keys (``"running_mean"``,
``"running_var"``), float32 whatever the compute dtype: the parameter
tree that ``apply_fn`` takes never holds them, so the bf16 cast of the
training step never reaches them.  A layer with state reads
``self.training`` and, in training mode, updates its buffers in place
under ``torch.no_grad()`` — the JAX ``apply_fn`` returns the new
buffer tree instead.  ``buffer_tree``/``set_buffer_tree`` carry that
state in and out (the training loop's guard snapshots it and restores
it on a skipped step).  Save/load and the Caffe/TF verbs are not ported
yet.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..device import DeviceLike, resolve_device


class AbstractModule(torch.nn.Module):
    """Base layer.  Subclasses register parameters with
    ``_register_param`` and implement ``_compute(params, x)``."""

    def __init__(self, device: DeviceLike = None):
        super().__init__()
        self._device = resolve_device(device)

    @property
    def device(self) -> torch.device:
        return self._device

    def _register_param(self, name: str, value: torch.Tensor):
        self.register_parameter(
            name, torch.nn.Parameter(value.to(self._device)))

    def _register_buffer(self, name: str, value: torch.Tensor):
        self.register_buffer(name, value.to(self._device))

    def set_name(self, name: str):
        self.name = name
        return self

    def get_name(self) -> str:
        return getattr(self, "name", None) or type(self).__name__

    # ------------------------------------------------------------------
    # functional core
    # ------------------------------------------------------------------
    def _compute(self, params: Dict, x):
        raise NotImplementedError(
            f"{type(self).__name__} must implement _compute")

    def apply_fn(self, params: Dict, x):
        """The forward over an explicit parameter tree (the cast tree
        of bf16 serving, or ``param_tree()``)."""
        return self._compute(params, x)

    def forward(self, x):
        return self.apply_fn(self.param_tree(), x)

    # ------------------------------------------------------------------
    # parameter / buffer trees
    # ------------------------------------------------------------------
    def param_tree(self) -> Dict:
        """Own parameters plus each child's tree under its key — the
        JAX package's ``param_tree()`` layout, holding the live
        parameters."""
        tree = dict(self.named_parameters(recurse=False))
        for key, child in self.named_children():
            tree[key] = child.param_tree()
        return tree

    def set_param_tree(self, tree: Dict, _path: str = ""):
        """Copy ``tree`` (nested dicts of tensors) into the parameters
        in place, each cast to the parameter's dtype and device.  Raises
        ``KeyError`` on a missing or extra key and ``ValueError`` on a
        shape mismatch, naming the dotted path."""
        return self._copy_tree(tree, "param", _path)

    def _copy_tree(self, tree: Dict, kind: str, _path: str):
        own = dict(self.named_parameters(recurse=False) if kind == "param"
                   else self.named_buffers(recurse=False))
        children = dict(self.named_children())
        expected = set(own) | set(children)
        missing = sorted(expected - set(tree))
        extra = sorted(set(tree) - expected)
        if missing or extra:
            raise KeyError(
                f"{kind} tree at {_path or '<root>'}: missing "
                f"{[_path + k for k in missing]}, extra "
                f"{[_path + k for k in extra]}")
        for key, p in own.items():
            value = torch.as_tensor(tree[key])
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(
                    f"{kind} {_path + key}: shape {tuple(value.shape)} != "
                    f"expected {tuple(p.shape)}")
            with torch.no_grad():
                p.copy_(value.to(device=p.device, dtype=p.dtype))
        for key, child in children.items():
            child._copy_tree(tree[key], kind, f"{_path}{key}.")
        return self

    def buffer_tree(self) -> Dict:
        """Own buffers plus each child's tree under its key — the JAX
        package's ``buffer_tree()`` layout, holding the live buffers."""
        tree = dict(self.named_buffers(recurse=False))
        for key, child in self.named_children():
            tree[key] = child.buffer_tree()
        return tree

    def set_buffer_tree(self, tree: Dict, _path: str = ""):
        """Copy ``tree`` into the buffers in place, each cast to the
        buffer's dtype and device; the key and shape checks of
        ``set_param_tree``."""
        return self._copy_tree(tree, "buffer", _path)

    def evaluate(self, *args, **kwargs):
        """No arguments: switch to eval mode (the JAX package's no-arg
        ``evaluate``).  With a dataset and validation methods: run them
        (``optim.evaluator.Evaluator(self).test``)."""
        if not args and not kwargs:
            self.eval()
            return self
        from ..optim.evaluator import Evaluator

        return Evaluator(self).test(*args, **kwargs)

    def train(self, mode: bool = True):
        """Switch to training mode: the JAX package's ``training()``,
        spelled as PyTorch's verb, since ``training`` is a bool
        attribute of every ``torch.nn.Module``.  Training also makes
        every parameter require a gradient.  ``train(False)`` is
        ``eval()``, as in PyTorch."""
        super().train(mode)
        if mode:
            for p in self.parameters():
                p.requires_grad_(True)
        return self


class TensorModule(AbstractModule):
    """Module whose input and output are single tensors."""


class Container(AbstractModule):
    """Base container: children registered under ``"0"``, ``"1"``, …"""

    def __init__(self, *modules: AbstractModule, device: DeviceLike = None):
        super().__init__(device)
        for m in modules:
            self.add(m)

    def add(self, module: AbstractModule):
        self.add_module(str(len(self)), module)
        return self

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, i: int) -> AbstractModule:
        return self._modules[str(i % len(self))]
