"""Weight regularizers (counterpart of ``bigdl_tpu/optim/regularizer.py``;
reference optim/Regularizer.scala:30/87/186).

A regularizer is a penalty term, ``l1*|w|₁ + (l2/2)*|w|₂²``, whose
gradient the training step takes by autograd and adds to the loss
gradient (``optim/optimizer.py``).  The step walks the module tree for
``w_regularizer``/``b_regularizer`` attributes exactly as the JAX step
does: through ``Container`` children only, and only to their
``weight`` and ``bias``.
"""
from __future__ import annotations

import torch


class Regularizer:
    def loss(self, param) -> torch.Tensor:
        raise NotImplementedError


class L1L2Regularizer(Regularizer):
    def __init__(self, l1: float = 0.0, l2: float = 0.0):
        self.l1, self.l2 = l1, l2

    def loss(self, param):
        out = 0.0
        if self.l1:
            # |w| with the JAX package's derivative at 0 (+1, where
            # torch.abs gives 0): w times its sign, the sign a constant
            sign = torch.where(param >= 0, 1.0, -1.0).to(param.dtype)
            out = out + self.l1 * torch.sum(param * sign)
        if self.l2:
            out = out + 0.5 * self.l2 * torch.sum(torch.square(param))
        return out


class L1Regularizer(L1L2Regularizer):
    def __init__(self, l1: float):
        super().__init__(l1=l1)


class L2Regularizer(L1L2Regularizer):
    def __init__(self, l2: float):
        super().__init__(l2=l2)


def collect_regularizer_paths(module, prefix=()):
    """Yield (param_tree_path, regularizer) pairs over a module tree.

    Paths address the module's ``param_tree`` (children keyed by
    ``str(index)``, leaf parameters by name)."""
    from ..nn.module import Container

    if isinstance(module, Container):
        for i, child in enumerate(module.children()):
            yield from collect_regularizer_paths(child, prefix + (str(i),))
    else:
        own = dict(module.named_parameters(recurse=False))
        wr = getattr(module, "w_regularizer", None)
        br = getattr(module, "b_regularizer", None)
        if wr is not None and "weight" in own:
            yield prefix + ("weight",), wr
        if br is not None and "bias" in own:
            yield prefix + ("bias",), br


def regularizer_loss(param_tree, reg_paths):
    total = 0.0
    for path, reg in reg_paths:
        node = param_tree
        for key in path:
            node = node[key]
        total = total + reg.loss(node)
    return total
