"""ValidationMethod + results (counterpart of
``bigdl_tpu/optim/validation.py``; reference optim/ValidationMethod.scala:
TreeNNAccuracy:118, Top1Accuracy:170, Top5Accuracy:218, Loss:312,
MAE:332) with monoid ``ValidationResult``s that add across batches.

Each method reduces on the output's own device and reads back only its
count or sum (one small read-back a batch): the JAX methods pull the
whole output to the host first, which at the flagship's (B, T, 32000)
logits would move gigabytes a batch to count correct argmaxes.  Results
hold plain Python numbers, equal to the JAX package's on the same
outputs.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(a, device=None) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    return t if device is None else t.to(device)


class ValidationResult:
    def result(self):
        raise NotImplementedError

    def __add__(self, other):
        raise NotImplementedError


class AccuracyResult(ValidationResult):
    def __init__(self, correct: int, count: int):
        self.correct, self.count = int(correct), int(count)

    def result(self):
        return (self.correct / max(self.count, 1), self.count)

    def __add__(self, other):
        return AccuracyResult(self.correct + other.correct,
                              self.count + other.count)

    def __eq__(self, other):
        return (isinstance(other, AccuracyResult)
                and (self.correct, self.count) == (other.correct, other.count))

    def __repr__(self):
        acc, n = self.result()
        return f"Accuracy(correct: {self.correct}, count: {n}, accuracy: {acc})"


class LossResult(ValidationResult):
    def __init__(self, loss: float, count: int):
        self.loss, self.count = float(loss), int(count)

    def result(self):
        return (self.loss / max(self.count, 1), self.count)

    def __add__(self, other):
        return LossResult(self.loss + other.loss, self.count + other.count)

    def __repr__(self):
        avg, n = self.result()
        return f"Loss(loss: {self.loss}, count: {n}, average: {avg})"


class ValidationMethod:
    def apply(self, output, target) -> ValidationResult:
        raise NotImplementedError

    def __call__(self, output, target):
        with torch.no_grad():
            return self.apply(output, target)

    def format(self) -> str:
        return type(self).__name__


class TreeNNAccuracy(ValidationMethod):
    """Root-node accuracy for tree models (reference :118): the first
    node's output against the first label; one output column thresholds
    at 0.5, more take the argmax."""

    def apply(self, output, target):
        out = _tensor(output)
        t = _tensor(target, out.device)
        if out.dim() == 3:                      # (B, N, C) -> root node
            out = out[:, 0, :]
            t = t.reshape(t.shape[0], -1)[:, 0]
        elif out.dim() == 2:                    # one sample (N, C)
            out = out[0:1, :]
            t = t.reshape(-1)[:1]
        else:
            raise ValueError("TreeNNAccuracy expects 2-D or 3-D output")
        if out.shape[-1] == 1:
            pred = (out[:, 0] >= 0.5).to(torch.int64)
        else:
            pred = out.argmax(dim=-1) + 1
        correct = (pred == t.to(torch.int64)).sum().item()
        return AccuracyResult(correct, out.shape[0])

    def format(self):
        return "TreeNNAccuracy()"


class Top1Accuracy(ValidationMethod):
    """reference :170 — argmax against 1-based labels."""

    def apply(self, output, target):
        out = _tensor(output)
        t = _tensor(target, out.device).reshape(-1)
        if out.dim() == 1:
            out = out[None]
        pred = out.argmax(dim=-1) + 1
        correct = (pred == t.to(torch.int64)).sum().item()
        return AccuracyResult(correct, t.shape[0])

    def format(self):
        return "Top1Accuracy"


class Top5Accuracy(ValidationMethod):
    """reference :218"""

    def apply(self, output, target):
        out = _tensor(output)
        t = _tensor(target, out.device).reshape(-1).to(torch.int64)
        if out.dim() == 1:
            out = out[None]
        top5 = torch.topk(out, min(5, out.shape[-1]), dim=-1).indices + 1
        correct = (top5 == t[:, None]).any(dim=1).sum().item()
        return AccuracyResult(correct, t.shape[0])

    def format(self):
        return "Top5Accuracy"


class Loss(ValidationMethod):
    """The criterion's loss as a validation metric (reference :312):
    the batch's loss times its record count, summed over batches."""

    def __init__(self, criterion=None):
        from ..nn.criterion import ClassNLLCriterion

        self.criterion = criterion or ClassNLLCriterion()

    def apply(self, output, target):
        out = _tensor(output)
        loss = self.criterion._loss(out, _tensor(target, out.device))
        n = out.shape[0]
        return LossResult(float(loss) * n, n)

    def format(self):
        return "Loss"


class MAE(ValidationMethod):
    """Mean absolute error of the argmax class (reference :332)."""

    def apply(self, output, target):
        out = _tensor(output)
        t = _tensor(target, out.device).reshape(-1)
        pred = out.argmax(dim=-1) + 1
        err = (pred.to(torch.float64) - t.to(torch.float64)).abs().sum()
        return LossResult(err.item(), t.shape[0])

    def format(self):
        return "MAE"
