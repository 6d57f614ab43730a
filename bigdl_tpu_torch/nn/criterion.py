"""Criterions (counterpart of ``bigdl_tpu/nn/criterion.py``, trimmed to
the classification criterions of the training slice; reference
nn/abstractnn/AbstractCriterion.scala:49).

Each criterion defines one ``_loss(input, target) -> scalar`` in plain
PyTorch; ``backward`` is autograd of it.  Class labels are 1-based, as
in the reference.
"""
from __future__ import annotations

import torch

from ..ops.fused_xent import softmax_xent_rows


class AbstractCriterion:
    # Criterions that accumulate internally in f32 set this True: the
    # mixed-precision training loop then skips the blanket f32 upcast of the
    # model output, which at LM vocab sizes would materialise a
    # gigabyte-scale [N, V] tensor the fused path exists to avoid.
    accepts_low_precision = False

    def __init__(self):
        self.output = 0.0
        self.grad_input = None
        self.size_average = True

    def _loss(self, inp, target):
        raise NotImplementedError

    def update_output(self, inp, target):
        self.output = float(self._loss(torch.as_tensor(inp),
                                       torch.as_tensor(target)))
        return self.output

    def forward(self, inp, target):
        return self.update_output(inp, target)

    def update_grad_input(self, inp, target):
        x = torch.as_tensor(inp).detach().requires_grad_()
        with torch.enable_grad():
            loss = self._loss(x, torch.as_tensor(target))
        self.grad_input = torch.autograd.grad(loss, x)[0]
        return self.grad_input

    def backward(self, inp, target):
        return self.update_grad_input(inp, target)

    def __call__(self, inp, target):
        return self.forward(inp, target)


def _zero_based(target: torch.Tensor) -> torch.Tensor:
    """1-based labels (ints, or floats truncated as ``astype(int32)``
    does) as flat 0-based int64 class ids."""
    return target.to(torch.int64).reshape(-1) - 1


class ClassNLLCriterion(AbstractCriterion):
    """NLL over log-probabilities, 1-based targets, optional class
    weights (reference nn/ClassNLLCriterion.scala:60)."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self.weights = None if weights is None else torch.as_tensor(weights)
        self.size_average = size_average

    def _loss(self, inp, target):
        if inp.dim() == 1:
            inp = inp[None]
            target = target.reshape(1)
        t = _zero_based(target)
        picked = inp.gather(1, t[:, None])[:, 0]
        if self.weights is not None:
            w = self.weights.to(device=inp.device)[t]
            total = w.sum()
            s = -(w * picked).sum()
            return s / total if self.size_average else s
        return -(picked.mean() if self.size_average else picked.sum())


class CrossEntropyCriterion(AbstractCriterion):
    """LogSoftMax + ClassNLL fused (reference nn/CrossEntropyCriterion.scala).

    The unweighted path uses ``ops.fused_xent``: logits stay in their
    compute dtype, the log-sum-exp accumulates in f32, and the backward
    recomputes the softmax instead of storing it."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self.nll = ClassNLLCriterion(weights, size_average)
        self.size_average = size_average
        # the fused path accumulates f32 internally; bf16 logits welcome
        self.accepts_low_precision = weights is None

    def _loss(self, inp, target):
        if self.nll.weights is not None:
            return self.nll._loss(torch.log_softmax(inp, dim=-1), target)
        if inp.dim() == 1:
            inp = inp[None]
        rows = softmax_xent_rows(inp.reshape(-1, inp.shape[-1]),
                                 _zero_based(target))
        return rows.mean() if self.size_average else rows.sum()


class TimeDistributedCriterion(AbstractCriterion):
    """Apply a criterion at every timestep (reference
    nn/TimeDistributedCriterion.scala)."""

    def __init__(self, critrn: AbstractCriterion, size_average: bool = False):
        super().__init__()
        self.critrn = critrn
        self.size_average = size_average
        self.accepts_low_precision = critrn.accepts_low_precision

    def _loss(self, inp, target):
        steps = inp.shape[1]
        c = self.critrn
        # Fused path for the classification criterions: sum_t mean_b ==
        # steps * mean_{b,t}, so one flattened (B*T, V) call replaces T
        # per-timestep calls.
        flat_ok = (isinstance(c, (ClassNLLCriterion, CrossEntropyCriterion))
                   and c.size_average and inp.dim() == 3
                   and (c.weights if isinstance(c, ClassNLLCriterion)
                        else c.nll.weights) is None)
        if flat_ok:
            flat = c._loss(inp.reshape(-1, inp.shape[-1]),
                           target.reshape(-1))
            return flat if self.size_average else flat * steps

        total = sum(c._loss(inp[:, i], target[:, i]) for i in range(steps))
        return total / steps if self.size_average else total
