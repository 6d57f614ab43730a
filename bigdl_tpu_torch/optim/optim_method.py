"""Optimization methods (counterpart of ``bigdl_tpu/optim/optim_method.py``;
reference optim/OptimMethod.scala:28, SGD.scala:38, Adam.scala:40,
Adagrad, Adadelta, Adamax, RMSprop, LBFGS).

The same split as the JAX package:

- ``init_state(params)`` gives the optimizer slots, a tree shaped like
  the parameter tree (nested dicts of tensors);
- ``step(grads, params, slots, lr)`` gives ``(new_params, new_slots)``
  and is functional, the JAX ``step`` term for term: it allocates new
  tensors and leaves its arguments alone.  The training loop runs it
  under ``torch.no_grad()`` and writes the result into the live
  parameters and slots in place (``optim/optimizer.py``), after the
  gradient guard has chosen between it and the old state;
- ``lr`` comes from the host-side schedule, ``get_current_lr()``;
- ``optimize(feval, x)`` is the Torch-parity loop over ``step``
  (OptimMethod.scala:28), used by tests and by LBFGS, which is
  host-driven and has no ``step``.

The state table keys mirror the reference (``epoch``, ``neval``), so
schedules resume from checkpoints (OptimMethod.scala:80-96).  A pickled
method carries its slots on the CPU; ``load(path, device)`` puts them
on ``device``.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..utils.table import T
from ..utils.tree import tree_leaves, tree_map

tmap = tree_map


def _count(params) -> torch.Tensor:
    """A step counter slot, on the parameters' device."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.vdot`` of real tensors: the dot product of the flattened
    operands."""
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _on_cpu(tree):
    return tmap(lambda v: v.detach().cpu() if torch.is_tensor(v) else v,
                tree)


class OptimMethod:
    def __init__(self):
        self.state = T(epoch=1, neval=1)
        self._slots = None

    # -- functional core -------------------------------------------------
    def init_state(self, params):
        return {}

    def step(self, grads, params, state, lr):
        raise NotImplementedError

    # -- host-side schedule ----------------------------------------------
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

    # -- Torch-parity mutating loop --------------------------------------
    def optimize(self, feval: Callable, x):
        """``feval(x) -> (loss, grad)``; returns (new_x, [loss])."""
        loss, grad = feval(x)
        if self._slots is None:
            self._slots = self.init_state(x)
        self.update_state(neval=self.state.get("neval", 1))
        lr = self.get_current_lr()
        with torch.no_grad():
            new_x, self._slots = self.step(grad, x, self._slots, lr)
        self.state["neval"] = self.state.get("neval", 1) + 1
        return new_x, [loss]

    def clear_history(self):
        self._slots = None
        self.state = T(epoch=1, neval=1)
        return self

    def get_hyper_parameter(self) -> str:
        return f"Current learning rate is {self.get_current_lr()}."

    def save(self, path: str, overwrite: bool = False):
        from ..utils.file_io import save as _save

        _save(self, path, overwrite)
        return self

    @staticmethod
    def load(path: str, device=None) -> "OptimMethod":
        """The method saved at ``path``, its slots on ``device`` (the
        CPU when ``None``)."""
        from ..utils.file_io import load as _load
        from ..utils.file_io import to_device

        method = _load(path)
        if device is not None and method._slots is not None:
            method._slots = to_device(method._slots, torch.device(device))
        return method

    # pickle: the slots travel as CPU tensors (``utils/file_io`` then
    # writes each as its raw bytes)
    def __getstate__(self):
        state = dict(self.__dict__)
        state["_slots"] = _on_cpu(state.get("_slots"))
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)


# ---------------------------------------------------------------------------
# Learning-rate schedules (reference SGD.scala:203-582)
# All are host-side: pure functions of the state table → current lr, fed to
# the jitted step as a dynamic scalar.
# ---------------------------------------------------------------------------
class LearningRateSchedule:
    def get_lr(self, opt: "SGD") -> float:
        raise NotImplementedError


class Default(LearningRateSchedule):
    """lr / (1 + neval*learningRateDecay) (reference SGD.Default)."""

    def get_lr(self, opt):
        n = opt.state.get("neval", 1) - 1
        return opt.learning_rate / (1 + n * opt.learning_rate_decay)


class Step(LearningRateSchedule):
    """lr * gamma^(floor(neval/stepSize)) (reference SGD.Step)."""

    def __init__(self, step_size: int, gamma: float):
        self.step_size, self.gamma = step_size, gamma

    def get_lr(self, opt):
        n = opt.state.get("neval", 1) - 1
        return opt.learning_rate * self.gamma ** (n // self.step_size)


class MultiStep(LearningRateSchedule):
    """reference SGD.MultiStep"""

    def __init__(self, step_sizes, gamma: float):
        self.step_sizes, self.gamma = list(step_sizes), gamma

    def get_lr(self, opt):
        n = opt.state.get("neval", 1) - 1
        k = sum(1 for s in self.step_sizes if n >= s)
        return opt.learning_rate * self.gamma ** k


class EpochStep(LearningRateSchedule):
    """lr * gamma^(floor(epoch/stepSize)) (reference SGD.EpochStep)."""

    def __init__(self, step_size: int, gamma: float):
        self.step_size, self.gamma = step_size, gamma

    def get_lr(self, opt):
        e = opt.state.get("epoch", 1)
        return opt.learning_rate * self.gamma ** (e // self.step_size)


class EpochDecay(LearningRateSchedule):
    """lr * 0.1^decayType(epoch) (reference SGD.EpochDecay)."""

    def __init__(self, decay_fn: Callable[[int], float]):
        self.decay_fn = decay_fn

    def get_lr(self, opt):
        e = opt.state.get("epoch", 1)
        return opt.learning_rate * (0.1 ** self.decay_fn(e))


class EpochSchedule(LearningRateSchedule):
    """Explicit (startEpoch, lr) regimes (reference SGD.EpochSchedule)."""

    def __init__(self, regimes):
        # regimes: list of dicts/tuples (start_epoch, end_epoch, lr)
        self.regimes = regimes

    def get_lr(self, opt):
        e = opt.state.get("epoch", 1)
        for r in self.regimes:
            start, end, lr = r
            if start <= e <= end:
                return lr
        return opt.learning_rate


class Regime:
    def __init__(self, start_epoch, end_epoch, config):
        self.start_epoch, self.end_epoch = start_epoch, end_epoch
        self.config = config


class Poly(LearningRateSchedule):
    """lr * (1 - neval/maxIteration)^power (reference SGD.Poly)."""

    def __init__(self, power: float, max_iteration: int):
        self.power, self.max_iteration = power, max_iteration

    def get_lr(self, opt):
        n = opt.state.get("neval", 1) - 1
        if n > self.max_iteration:
            return 0.0
        return opt.learning_rate * (1 - n / self.max_iteration) ** self.power


class Exponential(LearningRateSchedule):
    """lr * decayRate^(neval/decayStep) (reference SGD.Exponential)."""

    def __init__(self, decay_step: int, decay_rate: float,
                 stair_case: bool = False):
        self.decay_step, self.decay_rate = decay_step, decay_rate
        self.stair_case = stair_case

    def get_lr(self, opt):
        n = opt.state.get("neval", 1) - 1
        exp = n // self.decay_step if self.stair_case else n / self.decay_step
        return opt.learning_rate * self.decay_rate ** exp


class NaturalExp(LearningRateSchedule):
    """lr * exp(-gamma * floor(neval/decayStep)) (reference SGD.NaturalExp)."""

    def __init__(self, decay_step: int, gamma: float):
        self.decay_step, self.gamma = decay_step, gamma

    def get_lr(self, opt):
        n = opt.state.get("neval", 1) - 1
        return opt.learning_rate * math.exp(
            -self.gamma * (n // self.decay_step))


class Plateau(LearningRateSchedule):
    """Reduce lr when a monitored score plateaus (reference SGD.Plateau)."""

    def __init__(self, monitor: str = "score", factor: float = 0.1,
                 patience: int = 10, mode: str = "min", epsilon: float = 1e-4,
                 cooldown: int = 0, min_lr: float = 0.0):
        self.monitor, self.factor, self.patience = monitor, factor, patience
        self.mode, self.epsilon = mode, epsilon
        self.cooldown, self.min_lr = cooldown, min_lr
        self._wait = 0
        self._cooldown_counter = 0
        self._best = None
        self._current = None

    def _better(self, a, b):
        if self.mode == "min":
            return a < b - self.epsilon
        return a > b + self.epsilon

    def get_lr(self, opt):
        cur = opt.state.get(self.monitor,
                            opt.state.get("loss" if self.monitor == "score"
                                          else "score"))
        if self._current is None:
            self._current = opt.learning_rate
        if cur is None:
            return self._current
        if self._best is None or self._better(cur, self._best):
            self._best = cur
            self._wait = 0
        elif self._cooldown_counter > 0:
            self._cooldown_counter -= 1
            self._wait = 0
        else:
            self._wait += 1
            if self._wait >= self.patience:
                self._current = max(self._current * self.factor, self.min_lr)
                self._cooldown_counter = self.cooldown
                self._wait = 0
        return self._current


# ---------------------------------------------------------------------------
# SGD (reference optim/SGD.scala:38)
# ---------------------------------------------------------------------------
class SGD(OptimMethod):
    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0,
                 weight_decay: float = 0.0, momentum: float = 0.0,
                 dampening: Optional[float] = None, nesterov: bool = False,
                 learning_rate_schedule: Optional[LearningRateSchedule]
                 = None):
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
        return {"m": tmap(torch.zeros_like, params),
                "v": tmap(torch.zeros_like, params),
                "t": _count(params)}

    def step(self, grads, params, state, lr):
        t = state["t"] + 1
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        m = tmap(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        v = tmap(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state["v"], grads)
        tc = t.to(torch.float32)
        bc1 = 1 - torch.pow(b1, tc)
        bc2 = 1 - torch.pow(b2, tc)
        new_params = tmap(
            lambda p, m_, v_:
            p - lr * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps),
            params, m, v)
        return new_params, {"m": m, "v": v, "t": t}


class Adagrad(OptimMethod):
    """reference optim/Adagrad.scala"""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0, weight_decay: float = 0.0):
        super().__init__()
        self.learning_rate = learning_rate
        self.learning_rate_decay = learning_rate_decay
        self.weight_decay = weight_decay

    def get_current_lr(self):
        n = self.state.get("neval", 1) - 1
        return self.learning_rate / (1 + n * self.learning_rate_decay)

    def init_state(self, params):
        return {"accum": tmap(torch.zeros_like, params)}

    def step(self, grads, params, state, lr):
        if self.weight_decay > 0:
            grads = tmap(lambda g, p: g + self.weight_decay * p, grads, params)
        accum = tmap(lambda a, g: a + g * g, state["accum"], grads)
        new_params = tmap(lambda p, g, a: p - lr * g / (torch.sqrt(a) + 1e-10),
                          params, grads, accum)
        return new_params, {"accum": accum}


class Adadelta(OptimMethod):
    """reference optim/Adadelta.scala"""

    def __init__(self, decay_rate: float = 0.9, epsilon: float = 1e-10):
        super().__init__()
        self.decay_rate, self.epsilon = decay_rate, epsilon
        self.learning_rate = 1.0

    def init_state(self, params):
        return {"accum": tmap(torch.zeros_like, params),
                "delta_accum": tmap(torch.zeros_like, params)}

    def step(self, grads, params, state, lr):
        rho, eps = self.decay_rate, self.epsilon
        accum = tmap(lambda a, g: rho * a + (1 - rho) * g * g,
                     state["accum"], grads)
        update = tmap(
            lambda g, a, d: g * torch.sqrt(d + eps) / torch.sqrt(a + eps),
                      grads, accum, state["delta_accum"])
        delta = tmap(lambda d, u: rho * d + (1 - rho) * u * u,
                     state["delta_accum"], update)
        new_params = tmap(lambda p, u: p - lr * u, params, update)
        return new_params, {"accum": accum, "delta_accum": delta}


class Adamax(OptimMethod):
    """reference optim/Adamax.scala"""

    def __init__(self, learning_rate: float = 2e-3, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-38):
        super().__init__()
        self.learning_rate = learning_rate
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_state(self, params):
        return {"m": tmap(torch.zeros_like, params),
                "u": tmap(torch.zeros_like, params),
                "t": _count(params)}

    def step(self, grads, params, state, lr):
        t = state["t"] + 1
        b1, b2 = self.beta1, self.beta2
        m = tmap(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        u = tmap(lambda u_, g: torch.maximum(b2 * u_,
                                             torch.abs(g) + self.epsilon),
                 state["u"], grads)
        bc = 1 - torch.pow(b1, t.to(torch.float32))
        new_params = tmap(lambda p, m_, u_: p - (lr / bc) * m_ / u_,
                          params, m, u)
        return new_params, {"m": m, "u": u, "t": t}


class RMSprop(OptimMethod):
    """reference optim/RMSprop.scala"""

    def __init__(self, learning_rate: float = 1e-2,
                 learning_rate_decay: float = 0.0, decay_rate: float = 0.99,
                 epsilon: float = 1e-8):
        super().__init__()
        self.learning_rate = learning_rate
        self.learning_rate_decay = learning_rate_decay
        self.decay_rate, self.epsilon = decay_rate, epsilon

    def get_current_lr(self):
        n = self.state.get("neval", 1) - 1
        return self.learning_rate / (1 + n * self.learning_rate_decay)

    def init_state(self, params):
        return {"accum": tmap(torch.zeros_like, params)}

    def step(self, grads, params, state, lr):
        rho = self.decay_rate
        accum = tmap(lambda a, g: rho * a + (1 - rho) * g * g,
                     state["accum"], grads)
        new_params = tmap(
            lambda p, g, a: p - lr * g / (torch.sqrt(a) + self.epsilon),
            params, grads, accum)
        return new_params, {"accum": accum}


class LBFGS(OptimMethod):
    """Limited-memory BFGS with optional Wolfe line search (reference
    optim/LBFGS.scala + LineSearch.scala lswolfe).

    Host-driven: uses ``feval`` repeatedly, so it only supports the
    ``optimize(feval, x)`` entry point (like the reference, it is not a
    per-step method for the distributed trainer).
    """

    def __init__(self, max_iter: int = 20, max_eval: Optional[float] = None,
                 tol_fun: float = 1e-5, tol_x: float = 1e-9,
                 n_correction: int = 100, learning_rate: float = 1.0,
                 line_search: bool = False):
        super().__init__()
        self.max_iter = max_iter
        self.max_eval = max_eval or max_iter * 1.25
        self.tol_fun, self.tol_x = tol_fun, tol_x
        self.n_correction = n_correction
        self.learning_rate = learning_rate
        self.line_search = line_search

    def optimize(self, feval, x):
        x = torch.as_tensor(x)
        old_dirs, old_stps = [], []
        f, g = feval(x)
        f_hist = [f]
        n_eval = 1
        d = -g
        g_prev, f_prev = g, f
        t = min(1.0, 1.0 / float(torch.sum(torch.abs(g)) + 1e-10)) \
            * self.learning_rate
        for it in range(self.max_iter):
            if it > 0:
                y = g - g_prev
                s = d * t
                ys = float(_vdot(y, s))
                if ys > 1e-10:
                    if len(old_dirs) >= self.n_correction:
                        old_dirs.pop(0)
                        old_stps.pop(0)
                    old_dirs.append(s)
                    old_stps.append(y)
                # two-loop recursion
                q = -g
                al = []
                for s_i, y_i in zip(reversed(old_dirs), reversed(old_stps)):
                    a_i = float(_vdot(s_i, q)) / float(_vdot(y_i, s_i))
                    q = q - a_i * y_i
                    al.append(a_i)
                if old_dirs:
                    gamma = (float(_vdot(old_dirs[-1], old_stps[-1]))
                             / float(_vdot(old_stps[-1], old_stps[-1])))
                    q = q * gamma
                for (s_i, y_i), a_i in zip(zip(old_dirs, old_stps),
                                           reversed(al)):
                    b_i = float(_vdot(y_i, q)) / float(_vdot(y_i, s_i))
                    q = q + (a_i - b_i) * s_i
                d = q
                t = self.learning_rate
            g_prev, f_prev = g, f
            gtd = float(_vdot(g, d))
            if gtd > -self.tol_x:
                break
            if self.line_search:
                t, f, g, x, ls_evals = self._lswolfe(feval, x, t, d, f, g, gtd)
                n_eval += ls_evals
            else:
                x = x + t * d
                f, g = feval(x)
                n_eval += 1
            f_hist.append(f)
            if n_eval >= self.max_eval:
                break
            if float(torch.max(torch.abs(t * d))) <= self.tol_x:
                break
            if abs(f - f_prev) < self.tol_fun:
                break
        self.state["neval"] = self.state.get("neval", 1) + 1
        return x, f_hist

    @staticmethod
    def _lswolfe(feval, x, t, d, f, g, gtd, c1=1e-4, c2=0.9, max_ls=25):
        """Strong-Wolfe backtracking/zoom line search (reference lswolfe)."""
        f0, gtd0 = f, gtd
        t_prev, f_prev, g_prev_, gtd_prev = 0.0, f, g, gtd
        evals = 0
        bracket = None
        for _ in range(max_ls):
            f_new, g_new = feval(x + t * d)
            evals += 1
            gtd_new = float(_vdot(g_new, d))
            if f_new > f0 + c1 * t * gtd0 or (evals > 1 and f_new >= f_prev):
                bracket = (t_prev, t, f_prev, f_new, g_prev_, g_new)
                break
            if abs(gtd_new) <= -c2 * gtd0:
                return t, f_new, g_new, x + t * d, evals
            if gtd_new >= 0:
                bracket = (t, t_prev, f_new, f_prev, g_new, g_prev_)
                break
            t_prev, f_prev, g_prev_, gtd_prev = t, f_new, g_new, gtd_new
            t = t * 2.0
        if bracket is None:
            return t, f_new, g_new, x + t * d, evals
        lo, hi, f_lo, f_hi, g_lo, g_hi = bracket
        for _ in range(max_ls):
            t = (lo + hi) / 2.0
            f_new, g_new = feval(x + t * d)
            evals += 1
            gtd_new = float(_vdot(g_new, d))
            if f_new > f0 + c1 * t * gtd0 or f_new >= f_lo:
                hi, f_hi, g_hi = t, f_new, g_new
            else:
                if abs(gtd_new) <= -c2 * gtd0:
                    break
                if gtd_new * (hi - lo) >= 0:
                    hi, f_hi, g_hi = lo, f_lo, g_lo
                lo, f_lo, g_lo = t, f_new, g_new
            if abs(hi - lo) < 1e-9:
                break
        return t, f_new, g_new, x + t * d, evals
