"""Optimization methods (counterpart of ``bigdl_tpu/optim/optim_method.py``,
trimmed to SGD and Adam; reference optim/OptimMethod.scala:28,
SGD.scala:38, Adam.scala:40).

The same split as the JAX package:

- ``init_state(params)`` gives the optimizer slots, a tree shaped like
  the parameter tree (nested dicts of tensors);
- ``step(grads, params, slots, lr)`` gives ``(new_params, new_slots)``
  and is functional, the JAX ``step`` term for term: it allocates new
  tensors and leaves its arguments alone.  The training loop runs it
  under ``torch.no_grad()`` and writes the result into the live
  parameters and slots in place (``optim/optimizer.py``), after the
  gradient guard has chosen between it and the old state;
- ``lr`` comes from the host-side schedule, ``get_current_lr()``.

The state table keys mirror the reference (``epoch``, ``neval``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..utils.table import T
from ..utils.tree import tree_leaves, tree_map

tmap = tree_map


class OptimMethod:
    def __init__(self):
        self.state = T(epoch=1, neval=1)
        self._slots = None

    def init_state(self, params):
        return {}

    def step(self, grads, params, state, lr):
        raise NotImplementedError

    def get_current_lr(self) -> float:
        return getattr(self, "learning_rate", 1.0)

    def update_state(self, epoch=None, neval=None, loss=None, score=None):
        if epoch is not None:
            self.state["epoch"] = epoch
        if neval is not None:
            self.state["neval"] = neval
        if loss is not None:
            self.state["loss"] = loss
        if score is not None:
            self.state["score"] = score

    def clear_history(self):
        self._slots = None
        self.state = T(epoch=1, neval=1)
        return self


class LearningRateSchedule:
    def get_lr(self, opt: "SGD") -> float:
        raise NotImplementedError


class Default(LearningRateSchedule):
    """lr / (1 + neval*learningRateDecay) (reference SGD.Default)."""

    def get_lr(self, opt):
        n = opt.state.get("neval", 1) - 1
        return opt.learning_rate / (1 + n * opt.learning_rate_decay)


class SGD(OptimMethod):
    """reference optim/SGD.scala:38: weight decay, momentum, dampening,
    nesterov, the ``Default`` schedule."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0,
                 weight_decay: float = 0.0, momentum: float = 0.0,
                 dampening: Optional[float] = None, nesterov: bool = False,
                 learning_rate_schedule: Optional[LearningRateSchedule] = None):
        super().__init__()
        self.learning_rate = learning_rate
        self.learning_rate_decay = learning_rate_decay
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.dampening = momentum if dampening is None else dampening
        self.nesterov = nesterov
        if nesterov and (momentum <= 0 or self.dampening != 0):
            raise ValueError("Nesterov requires momentum>0 and dampening=0 "
                             "(reference SGD.scala contract)")
        self.schedule = learning_rate_schedule or Default()

    def get_current_lr(self):
        return self.schedule.get_lr(self)

    def init_state(self, params):
        if self.momentum > 0:
            return {"velocity": tmap(torch.zeros_like, params)}
        return {}

    def step(self, grads, params, state, lr):
        wd, mom, damp = self.weight_decay, self.momentum, self.dampening
        if wd > 0:
            grads = tmap(lambda g, p: g + wd * p, grads, params)
        if mom > 0:
            v = tmap(lambda vel, g: mom * vel + (1 - damp) * g,
                     state["velocity"], grads)
            if self.nesterov:
                d = tmap(lambda g, vel: g + mom * vel, grads, v)
            else:
                d = v
            new_params = tmap(lambda p, dd: p - lr * dd, params, d)
            return new_params, {"velocity": v}
        return tmap(lambda p, g: p - lr * g, params, grads), state


class Adam(OptimMethod):
    """reference optim/Adam.scala:40"""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8):
        super().__init__()
        self.learning_rate = learning_rate
        self.learning_rate_decay = learning_rate_decay
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def get_current_lr(self):
        n = self.state.get("neval", 1) - 1
        return self.learning_rate / (1 + n * self.learning_rate_decay)

    def init_state(self, params):
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else None
        return {"m": tmap(torch.zeros_like, params),
                "v": tmap(torch.zeros_like, params),
                "t": torch.zeros((), dtype=torch.int32, device=device)}

    def step(self, grads, params, state, lr):
        t = state["t"] + 1
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        m = tmap(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        v = tmap(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state["v"], grads)
        tc = t.to(torch.float32)
        bc1 = 1 - torch.pow(b1, tc)
        bc2 = 1 - torch.pow(b2, tc)
        new_params = tmap(
            lambda p, m_, v_: p - lr * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps),
            params, m, v)
        return new_params, {"m": m, "v": v, "t": t}
