"""Gradient anomaly guard and loss-spike detector (counterpart of
``bigdl_tpu/resilience/guards.py``).

:func:`tree_finite` reduces trees of tensors to one device-side bool
"every floating leaf is finite", and :func:`where_tree` selects between
the post-update and pre-update trees under it.  A NaN/Inf step is
thereby skipped: parameters and optimizer slots come out bit-identical
to their pre-step values.  As in the JAX package this is select, not
branch: the predicate stays on the device, so the guard adds no host
sync of its own; the training loop reads it back together with the loss it
fetches anyway.

:class:`LossSpikeDetector` watches the loss the loop already reads back
and trips after K consecutive spikes; the loop answers with a rollback
to the newest verified checkpoint.
"""
from __future__ import annotations

import logging
import math
from typing import Optional

import torch

from ..utils.tree import tree_leaves, tree_map

log = logging.getLogger("bigdl_tpu")


def tree_finite(*trees) -> torch.Tensor:
    """Scalar bool tensor: every floating leaf of every tree is finite.
    Integer leaves pass vacuously."""
    ok = None
    for tree in trees:
        for leaf in tree_leaves(tree):
            if torch.is_tensor(leaf) and leaf.is_floating_point():
                fin = torch.isfinite(leaf).all()
                ok = fin if ok is None else ok & fin
    return torch.tensor(True) if ok is None else ok


def where_tree(pred: torch.Tensor, new_tree, old_tree):
    """Leaf-wise ``torch.where(pred, new, old)`` over matching trees:
    with ``pred`` False the old state rides through untouched."""
    return tree_map(lambda n, o: torch.where(pred, n, o), new_tree, old_tree)


class LossSpikeDetector:
    """K-consecutive-spike trigger over the training loss stream.

    A step is a *spike* when its loss exceeds ``ratio`` times the
    exponential moving average of recent non-spike losses, or is not
    finite.  ``k`` consecutive spikes trip the detector: ``update``
    returns True and the loop rolls back to the last good checkpoint.
    Host-side: one float compare per iteration on the loss the loop
    already fetched.
    """

    def __init__(self, k: int = 3, ratio: float = 2.0,
                 warmup: int = 10, ema_decay: float = 0.9):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if ratio <= 1.0:
            raise ValueError(f"ratio must be > 1, got {ratio}")
        self.k = int(k)
        self.ratio = float(ratio)
        self.warmup = int(warmup)
        self.ema_decay = float(ema_decay)
        self.reset()

    def reset(self):
        """Forget history (after a rollback the restored run re-warms
        on its own losses)."""
        self._ema: Optional[float] = None
        self._steps = 0
        self._consecutive = 0

    @property
    def consecutive_spikes(self) -> int:
        return self._consecutive

    def update(self, loss: float) -> bool:
        """Feed one iteration's loss; True means roll back now."""
        loss = float(loss)
        self._steps += 1
        finite = math.isfinite(loss)
        in_warmup = self._ema is None or self._steps <= self.warmup
        spike = not finite or (not in_warmup
                               and loss > self.ratio * self._ema)
        if spike:
            self._consecutive += 1
            log.warning("loss spike %d/%d: loss %.6g vs EMA %.6g",
                        self._consecutive, self.k, loss,
                        self._ema if self._ema is not None else float("nan"))
        else:
            self._consecutive = 0
            self._ema = (loss if self._ema is None else
                         self.ema_decay * self._ema
                         + (1.0 - self.ema_decay) * loss)
        if self._consecutive >= self.k:
            self._consecutive = 0
            return True
        return False
