"""Trigger DSL (counterpart of ``bigdl_tpu/optim/trigger.py``, a copy;
reference optim/Trigger.scala:27-127)."""
from __future__ import annotations

from ..utils.table import Table


class Trigger:
    def __init__(self, fn, name="trigger"):
        self._fn = fn
        self.name = name

    def __call__(self, state: Table) -> bool:
        return bool(self._fn(state))

    def and_(self, other: "Trigger") -> "Trigger":
        return Trigger(lambda s: self(s) and other(s), f"{self.name}&{other.name}")

    def or_(self, other: "Trigger") -> "Trigger":
        return Trigger(lambda s: self(s) or other(s), f"{self.name}|{other.name}")


def every_epoch() -> Trigger:
    """Fires at each epoch boundary (reference Trigger.everyEpoch).

    The reference triggers on recordsProcessedThisEpoch==0; the training
    loops here set ``epoch_finished`` exactly at that boundary."""
    return Trigger(lambda s: s.get("epoch_finished", False), "everyEpoch")


def several_iteration(interval: int) -> Trigger:
    """Fires every ``interval`` completed iterations.  Training loops
    check triggers after bumping neval, so completed == neval - 1."""
    return Trigger(lambda s: (s["neval"] - 1) % interval == 0,
                   f"severalIteration({interval})")


def max_epoch(maxv: int) -> Trigger:
    return Trigger(lambda s: s["epoch"] > maxv, f"maxEpoch({maxv})")


def max_iteration(maxv: int) -> Trigger:
    return Trigger(lambda s: s["neval"] > maxv, f"maxIteration({maxv})")


def max_score(maxv: float) -> Trigger:
    return Trigger(lambda s: s.get("score", float("-inf")) > maxv,
                   f"maxScore({maxv})")


def min_loss(minv: float) -> Trigger:
    return Trigger(lambda s: s.get("loss", float("inf")) < minv,
                   f"minLoss({minv})")
