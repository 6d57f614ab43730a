"""Criterions (counterpart of ``bigdl_tpu/nn/criterion.py``; reference
nn/abstractnn/AbstractCriterion.scala:49 and the criterion files,
SURVEY §2.4).

Each criterion defines one ``_loss(input, target) -> scalar`` in plain
PyTorch; ``backward`` is autograd of it, over every float tensor of the
input (a Table input gets a Table of gradients; targets are never
differentiated).  Class labels are 1-based, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.fused_xent import softmax_xent_rows
from ..utils.table import Table
from .module import _grad_leaves, activity_leaves, activity_map, to_activity


def _mean_or_sum(losses, size_average: bool):
    return losses.mean() if size_average else losses.sum()


def _weights(weights) -> Optional[torch.Tensor]:
    return None if weights is None else torch.as_tensor(to_activity(weights))


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
        with torch.no_grad():
            loss = self._loss(to_activity(inp), to_activity(target))
        self.output = float(loss)
        return self.output

    def forward(self, inp, target):
        return self.update_output(inp, target)

    def update_grad_input(self, inp, target):
        x = _grad_leaves(activity_map(torch.Tensor.detach, to_activity(inp)))
        leaves = [t for t in activity_leaves(x) if t.requires_grad]
        with torch.enable_grad():
            loss = self._loss(x, to_activity(target))
        grads = dict(zip(map(id, leaves), torch.autograd.grad(
            loss, leaves, allow_unused=True)))

        def grad_of(t):
            g = grads.get(id(t))
            return torch.zeros_like(t) if g is None else g

        self.grad_input = activity_map(grad_of, x)
        return self.grad_input

    def backward(self, inp, target):
        return self.update_grad_input(inp, target)

    def __call__(self, inp, target):
        return self.forward(inp, target)

    def clone_criterion(self):
        import copy

        return copy.deepcopy(self)


def _zero_based(target: torch.Tensor) -> torch.Tensor:
    """1-based labels (ints, or floats truncated as ``astype(int32)``
    does) as flat 0-based int64 class ids."""
    return target.to(torch.int64).reshape(-1) - 1


class ClassNLLCriterion(AbstractCriterion):
    """NLL over log-probabilities, 1-based targets, optional class
    weights (reference nn/ClassNLLCriterion.scala:60)."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self.weights = _weights(weights)
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


class MSECriterion(AbstractCriterion):
    """reference nn/MSECriterion.scala:32"""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def _loss(self, inp, target):
        return _mean_or_sum(torch.square(inp - target), self.size_average)


class AbsCriterion(AbstractCriterion):
    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def _loss(self, inp, target):
        return _mean_or_sum((inp - target).abs(), self.size_average)


class BCECriterion(AbstractCriterion):
    """Binary cross entropy with optional per-element weights
    (reference nn/BCECriterion.scala)."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self.weights = _weights(weights)
        self.size_average = size_average

    def _loss(self, inp, target):
        eps = 1e-12
        l = -(target * torch.log(inp + eps)
              + (1 - target) * torch.log1p(-inp + eps))
        if self.weights is not None:
            l = l * self.weights.to(inp.device)
        return _mean_or_sum(l, self.size_average)


class SmoothL1Criterion(AbstractCriterion):
    """Huber with delta 1 (reference nn/SmoothL1Criterion.scala)."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def _loss(self, inp, target):
        d = (inp - target).abs()
        return _mean_or_sum(torch.where(d < 1.0, 0.5 * d * d, d - 0.5),
                            self.size_average)


class SmoothL1CriterionWithWeights(AbstractCriterion):
    """Fast R-CNN's box loss with inside and outside weights (reference
    nn/SmoothL1CriterionWithWeights.scala): input a tensor, target
    Table(target, inside_w, outside_w); the sum divided by ``num`` > 0."""

    def __init__(self, sigma: float = 1.0, num: int = 0):
        super().__init__()
        self.sigma2 = sigma * sigma
        self.num = num

    def _loss(self, inp, target):
        t, w_in, w_out = target[1], target[2], target[3]
        d = (inp - t) * w_in
        ad = d.abs()
        l = torch.where(ad < 1.0 / self.sigma2, 0.5 * self.sigma2 * d * d,
                        ad - 0.5 / self.sigma2) * w_out
        s = l.sum()
        return s / self.num if self.num > 0 else s


class MarginCriterion(AbstractCriterion):
    """Hinge max(0, margin - y x) (reference nn/MarginCriterion.scala)."""

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__()
        self.margin = margin
        self.size_average = size_average

    def _loss(self, inp, target):
        return _mean_or_sum(torch.clamp_min(self.margin - inp * target, 0.0),
                            self.size_average)


def _first(target):
    return target[1] if isinstance(target, Table) else target


class MarginRankingCriterion(AbstractCriterion):
    """Input Table(x1, x2), y = ±1: max(0, -y (x1 - x2) + margin)
    (reference nn/MarginRankingCriterion.scala)."""

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__()
        self.margin = margin
        self.size_average = size_average

    def _loss(self, inp, target):
        y = _first(target)
        return _mean_or_sum(
            torch.clamp_min(-y * (inp[1] - inp[2]) + self.margin, 0.0),
            self.size_average)


class MultiMarginCriterion(AbstractCriterion):
    """Multi-class hinge over 1-based targets (reference
    nn/MultiMarginCriterion.scala): per sample, the sum over classes
    j != y of max(0, margin - x_y + x_j)^p, divided by the class count."""

    def __init__(self, p: int = 1, weights=None, margin: float = 1.0,
                 size_average: bool = True):
        super().__init__()
        self.p, self.margin = p, margin
        self.weights = _weights(weights)
        self.size_average = size_average

    def _loss(self, inp, target):
        if inp.dim() == 1:
            inp, target = inp[None], target.reshape(1)
        k = inp.shape[1]
        t = _zero_based(target)
        x_y = inp.gather(1, t[:, None])
        margins = torch.clamp_min(self.margin - x_y + inp, 0.0) ** self.p
        if self.weights is not None:
            margins = margins * self.weights.to(inp.device)[t][:, None]
        other = 1.0 - F.one_hot(t, k).to(inp.dtype)
        return _mean_or_sum((margins * other).sum(dim=1) / k,
                            self.size_average)


class MultiLabelMarginCriterion(AbstractCriterion):
    """Multi-label hinge (reference nn/MultiLabelMarginCriterion.scala):
    each row of the target lists 1-based labels and ends at its first 0;
    per sample, the sum over listed labels y and unlisted classes j of
    max(0, 1 - (x_y - x_j)), divided by the class count."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def _loss(self, inp, target):
        if inp.dim() == 1:
            inp, target = inp[None], target.reshape(1, -1)
        n, k = inp.shape
        t = target.to(torch.int64) - 1                     # -1: padding
        valid = (torch.cumprod((t >= 0).to(torch.int64), dim=1) > 0)
        t_safe = t.clamp(0, k - 1)
        is_target = torch.zeros((n, k), dtype=inp.dtype, device=inp.device)
        is_target.scatter_add_(1, t_safe, valid.to(inp.dtype))
        is_target = is_target.clamp_max(1.0)
        x_y = inp.gather(1, t_safe)
        hinge = torch.clamp_min(1.0 - (x_y[:, :, None] - inp[:, None, :]),
                                0.0)
        mask = valid.to(inp.dtype)[:, :, None] * (1.0 - is_target)[:, None, :]
        return _mean_or_sum((hinge * mask).sum(dim=(1, 2)) / k,
                            self.size_average)


class MultiLabelSoftMarginCriterion(AbstractCriterion):
    """Sigmoid and binary cross entropy per label, averaged over the
    labels (reference nn/MultiLabelSoftMarginCriterion.scala)."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self.weights = _weights(weights)
        self.size_average = size_average

    def _loss(self, inp, target):
        l = F.softplus(-inp) * target + F.softplus(inp) * (1 - target)
        if self.weights is not None:
            l = l * self.weights.to(inp.device)
        return _mean_or_sum(l.mean(dim=-1), self.size_average)


class HingeEmbeddingCriterion(AbstractCriterion):
    """y = 1: x; y = -1: max(0, margin - x) (reference
    nn/HingeEmbeddingCriterion.scala)."""

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__()
        self.margin = margin
        self.size_average = size_average

    def _loss(self, inp, target):
        return _mean_or_sum(torch.where(
            target > 0, inp, torch.clamp_min(self.margin - inp, 0.0)),
            self.size_average)


class L1HingeEmbeddingCriterion(AbstractCriterion):
    """The L1 distance d of Table(x1, x2): y = 1: d; y = -1:
    max(0, margin - d) (reference nn/L1HingeEmbeddingCriterion.scala)."""

    def __init__(self, margin: float = 1.0):
        super().__init__()
        self.margin = margin

    def _loss(self, inp, target):
        d = (inp[1] - inp[2]).abs().sum()
        y = torch.as_tensor(_first(target)).reshape(())
        return torch.where(y > 0, d, torch.clamp_min(self.margin - d, 0.0))


def _cos(a, b):
    return (a * b).sum(dim=-1) / torch.clamp_min(
        torch.linalg.vector_norm(a, dim=-1)
        * torch.linalg.vector_norm(b, dim=-1), 1e-12)


class CosineEmbeddingCriterion(AbstractCriterion):
    """y = 1: 1 - cos(x1, x2); y = -1: max(0, cos - margin) (reference
    nn/CosineEmbeddingCriterion.scala)."""

    def __init__(self, margin: float = 0.0, size_average: bool = True):
        super().__init__()
        self.margin = margin
        self.size_average = size_average

    def _loss(self, inp, target):
        x1, x2 = inp[1], inp[2]
        if x1.dim() == 1:
            x1, x2 = x1[None], x2[None]
        y = _first(target).reshape(-1)
        cos = _cos(x1, x2)
        return _mean_or_sum(torch.where(
            y > 0, 1.0 - cos, torch.clamp_min(cos - self.margin, 0.0)),
            self.size_average)


class CosineDistanceCriterion(AbstractCriterion):
    """1 - cos(input, target) (reference
    nn/CosineDistanceCriterion.scala)."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def _loss(self, inp, target):
        if inp.dim() == 1:
            inp, target = inp[None], target[None]
        return _mean_or_sum(1.0 - _cos(inp, target), self.size_average)


class DistKLDivCriterion(AbstractCriterion):
    """KL divergence of log-probability inputs from a target
    distribution (reference nn/DistKLDivCriterion.scala); the mean over
    the batch with ``size_average``."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def _loss(self, inp, target):
        l = torch.where(target > 0, target * (
            torch.log(torch.clamp_min(target, 1e-12)) - inp),
            torch.zeros_like(inp))
        n = inp.shape[0] if inp.dim() > 1 else 1
        return l.sum() / n if self.size_average else l.sum()


def _regular_simplex(n_classes: int) -> np.ndarray:
    """Regular (N-1)-simplex embedding, the reference's ``regsplex``
    (ClassSimplexCriterion.scala:43-62): rows are unit vectors with
    pairwise dot product -1/n, zero-padded to n_classes columns."""
    n = n_classes - 1
    a = np.zeros((n + 1, n), np.float64)
    for k in range(1, n + 1):
        i = k - 1
        if k == 1:
            a[i, i] = 1.0
        else:
            nrm = np.linalg.norm(a[i, :i])
            a[i, i] = np.sqrt(1.0 - nrm * nrm)
        c = (a[i, i] * a[i, i] - 1.0 - 1.0 / n) / a[i, i]
        a[k:, i] = c
    out = np.zeros((n + 1, n_classes), np.float32)
    out[:, :n] = a
    return out


class ClassSimplexCriterion(MSECriterion):
    """MSE against simplex-embedded 1-based class targets (reference
    nn/ClassSimplexCriterion.scala)."""

    def __init__(self, n_classes: int):
        super().__init__()
        self.n_classes = n_classes
        self.simplex = torch.from_numpy(_regular_simplex(n_classes))

    def _loss(self, inp, target):
        goal = self.simplex.to(inp.device, inp.dtype)[_zero_based(target)]
        return super()._loss(inp, goal)


class DiceCoefficientCriterion(AbstractCriterion):
    """1 - the dice overlap per row (reference
    nn/DiceCoefficientCriterion.scala)."""

    def __init__(self, size_average: bool = True, epsilon: float = 1.0):
        super().__init__()
        self.epsilon = epsilon
        self.size_average = size_average

    def _loss(self, inp, target):
        if inp.dim() == 1:
            inp, target = inp[None], target[None]
        inter = (inp * target).sum(dim=-1)
        union = inp.sum(dim=-1) + target.sum(dim=-1)
        dice = (2.0 * inter + self.epsilon) / (union + self.epsilon)
        return _mean_or_sum(1.0 - dice, self.size_average)


class L1Cost(AbstractCriterion):
    """sum(|input|); the target is ignored (reference nn/L1Cost.scala)."""

    def _loss(self, inp, target):
        return inp.abs().sum()


class SoftMarginCriterion(AbstractCriterion):
    """log(1 + exp(-y x)) (reference nn/SoftMarginCriterion.scala)."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def _loss(self, inp, target):
        return _mean_or_sum(F.softplus(-inp * target), self.size_average)


class SoftmaxWithCriterion(AbstractCriterion):
    """Caffe's softmax loss over (N, C) or (N, C, H, W) with 1-based
    labels (reference nn/SoftmaxWithCriterion.scala), read flat as the
    reference reads them, so Caffe's (N, 1, H, W) labels work.  Labels
    equal to ``ignore_label`` (Caffe's convention is 255) drop out of the
    loss and of the VALID count.  With no ``ignore_label``, a label
    outside 1..C raises on the host before anything is launched: a
    0-based label set must not train silently on nothing."""

    def __init__(self, ignore_label: Optional[int] = None,
                 normalize_mode: str = "VALID"):
        super().__init__()
        self.ignore_label = ignore_label
        self.normalize_mode = normalize_mode

    def _loss(self, inp, target):
        C = inp.shape[1]
        t0 = target.to(torch.int64) - 1
        if self.ignore_label is None:
            labels = t0.cpu()
            bad = (labels < 0) | (labels >= C)
            if bool(bad.any()):
                raise ValueError(
                    f"SoftmaxWithCriterion: {int(bad.sum())} target "
                    f"label(s) outside the 1-based range [1, {C}] and no "
                    "ignore_label configured (labels are 1-based; 0 "
                    "usually means 0-based inputs).  Set ignore_label to "
                    "skip them deliberately.")
        logp = torch.log_softmax(inp, dim=1)
        t = t0.clamp(0, C - 1).reshape((inp.shape[0], 1) + inp.shape[2:])
        picked = logp.gather(1, t)[:, 0]
        mask = (t0 >= 0) & (t0 < C)
        if self.ignore_label is not None:
            mask = mask & (target != self.ignore_label)
        mask = mask.to(inp.dtype).reshape(picked.shape)
        picked = picked * mask
        if self.normalize_mode == "VALID":
            return -picked.sum() / torch.clamp_min(mask.sum(), 1.0)
        if self.normalize_mode == "FULL":
            return -picked.sum() / picked.numel()
        if self.normalize_mode == "BATCH_SIZE":
            return -picked.sum() / inp.shape[0]
        return -picked.sum()


class ParallelCriterion(AbstractCriterion):
    """Weighted sum of criterions over input and target Tables
    (reference nn/ParallelCriterion.scala); ``repeat_target`` gives each
    the whole target."""

    def __init__(self, repeat_target: bool = False):
        super().__init__()
        self.repeat_target = repeat_target
        self.criterions = []
        self.weights = []

    def add(self, criterion: AbstractCriterion, weight: float = 1.0):
        self.criterions.append(criterion)
        self.weights.append(weight)
        return self

    def _loss(self, inp, target):
        total = 0.0
        for i, (c, w) in enumerate(zip(self.criterions, self.weights)):
            t = target if self.repeat_target else target[i + 1]
            total = total + w * c._loss(inp[i + 1], t)
        return total


class MultiCriterion(AbstractCriterion):
    """Weighted sum of criterions on the same input and target
    (reference nn/MultiCriterion.scala)."""

    def __init__(self):
        super().__init__()
        self.criterions = []
        self.weights = []

    def add(self, criterion: AbstractCriterion, weight: float = 1.0):
        self.criterions.append(criterion)
        self.weights.append(weight)
        return self

    def _loss(self, inp, target):
        return sum(w * c._loss(inp, target)
                   for c, w in zip(self.criterions, self.weights))
