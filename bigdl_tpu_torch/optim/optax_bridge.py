"""A ``torch.optim`` optimizer as an ``OptimMethod`` (counterpart of
``bigdl_tpu/optim/optax_bridge.py``, whose ``OptaxMethod`` wraps an optax
transformation).

``TorchOptimMethod(torch.optim.Adam, lr=1e-3)`` builds the optimizer
from a FACTORY and its arguments, once the parameters are known;
``TorchOptimMethod(opt=prebuilt)`` takes a built optimizer of one
parameter group and rebinds that group.

The port's ``step(grads, params, slots, lr)`` is functional and the
gradient guard keeps or drops its result as a whole (``where_tree`` over
the parameters and the slots), where ``torch.optim`` mutates its
parameters and keys its state by parameter object.  The bridge makes
the two meet:

- the optimizer steps private leaf tensors (the shadows), one per
  parameter leaf, which ``step`` fills from ``params`` and ``grads``
  (each gradient a copy: an optimizer may write into it);
- its state lives in the slot tree, not in the optimizer:
  ``{"count": the accepted steps, "state": {leaf path: {key: tensor}}}``,
  every tensor on its parameter's device.  ``step`` loads a copy of the
  slots into the optimizer, steps, hands back what the optimizer made of
  it as new slots, and clears the optimizer's own state.  So a step the
  guard skips leaves the slots, and with them the optimizer's state, as
  they were;
- ``init_state`` learns the state's layout from one step of the
  optimizer on throwaway copies with zero gradients, and gives that
  layout filled with zeros at count 0.  While the count is 0 ``step``
  starts the optimizer from its own empty state (``torch.optim``
  initialises lazily, not always with zeros: SGD's momentum buffer
  starts as the first gradient).  Reading the count is one device sync a
  step.

``learning_rate`` multiplies the optimizer's update ``p' - p`` (default
1.0: the optimizer's parameters as it wrote them), as ``OptaxMethod``'s
does; the optimizer's own ``lr`` is its schedule.

Checkpoints go through the factory and its arguments: the method
pickles without the optimizer and rebuilds it at its next step.  A
prebuilt optimizer refuses to pickle with a ``TypeError``.
"""
from __future__ import annotations

import torch

from ..utils.tree import tree_leaves, tree_map
from .optim_method import OptimMethod


def _per_leaf(params, state):
    """The leaves of ``state`` (a tree shaped as ``params`` whose leaves
    are dicts) in ``params``' leaf order."""
    if isinstance(params, dict):
        return [s for k in params for s in _per_leaf(params[k], state[k])]
    return [state]


class TorchOptimMethod(OptimMethod):
    """``TorchOptimMethod(torch.optim.Adam, lr=1e-3)`` or
    ``TorchOptimMethod(opt=my_optimizer)`` (not checkpointable)."""

    def __init__(self, factory=None, *args, opt=None,
                 learning_rate: float = 1.0, **kwargs):
        super().__init__()
        if (factory is None) == (opt is None):
            raise ValueError("pass exactly one of a factory (e.g. "
                             "torch.optim.Adam) or a prebuilt opt")
        if opt is not None and len(opt.param_groups) != 1:
            raise ValueError(f"a prebuilt optimizer must have one parameter "
                             f"group, not {len(opt.param_groups)}")
        self.learning_rate = learning_rate
        self._factory = factory
        self._factory_args = args
        self._factory_kwargs = kwargs
        self._opt = opt
        self._shadows = None
        # per leaf: {state key: (device, dtype)} as the optimizer keeps it
        self._kinds = None

    # -- the optimizer over the shadows ----------------------------------
    def _bind(self, leaves):
        shadows = self._shadows
        if shadows is not None and len(shadows) == len(leaves) and all(
                s.shape == p.shape and s.dtype == p.dtype
                and s.device == p.device for s, p in zip(shadows, leaves)):
            return shadows
        shadows = [torch.zeros_like(p).requires_grad_() for p in leaves]
        if self._factory is not None:
            self._opt = self._factory(shadows, *self._factory_args,
                                      **self._factory_kwargs)
        else:
            self._opt.param_groups[0]["params"] = shadows
        self._opt.state.clear()
        self._shadows = shadows
        self._kinds = None
        return shadows

    def _run(self, shadows, leaves, grads, state):
        """One optimizer step from ``state`` (a list of per-leaf dicts,
        or None for the optimizer's own empty start); returns the new
        leaves and the new per-leaf state, and keeps nothing."""
        opt = self._opt
        with torch.no_grad():
            for s, p, g in zip(shadows, leaves, grads):
                s.copy_(p)
                s.grad = g.detach().clone()
            opt.state.clear()
            if state is not None:
                for s, st, kinds in zip(shadows, state, self._kinds):
                    opt.state[s] = {k: v.to(device=kinds[k][0],
                                            dtype=kinds[k][1], copy=True)
                                    for k, v in st.items()}
            opt.step()
            new_leaves = [s.detach().clone() for s in shadows]
            new_state = [dict(opt.state.get(s, {})) for s in shadows]
            opt.state.clear()
            for s in shadows:
                s.grad = None
        return new_leaves, new_state

    # -- functional core -------------------------------------------------
    def init_state(self, params):
        leaves = tree_leaves(params)
        shadows = self._bind(leaves)
        _, state = self._run(shadows, leaves,
                             [torch.zeros_like(p) for p in leaves], None)
        for st in state:
            bad = [k for k, v in st.items() if not torch.is_tensor(v)]
            if bad:
                raise TypeError(f"{type(self._opt).__name__} keeps "
                                f"non-tensor state {bad}; the bridge holds "
                                "tensor state only")
        self._kinds = [{k: (v.device, v.dtype) for k, v in st.items()}
                       for st in state]
        it = iter([{k: torch.zeros_like(v, device=p.device)
                    for k, v in st.items()}
                   for st, p in zip(state, leaves)])
        device = leaves[0].device if leaves else None
        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                "state": tree_map(lambda _: next(it), params)}

    def step(self, grads, params, state, lr):
        leaves = tree_leaves(params)
        shadows = self._bind(leaves)
        if self._kinds is None:          # rebuilt after unpickling
            self.init_state(params)
        fresh = int(state["count"]) == 0
        old = None if fresh else _per_leaf(params, state["state"])
        new_leaves, new_state = self._run(shadows, leaves,
                                          tree_leaves(grads), old)
        if lr != 1.0:
            new_leaves = [p + lr * (n - p)
                          for p, n in zip(leaves, new_leaves)]
        it = iter(new_leaves)
        new_params = tree_map(lambda _: next(it), params)
        it = iter([{k: v.to(p.device) for k, v in st.items()}
                    for st, p in zip(new_state, leaves)])
        return new_params, {"count": state["count"] + 1,
                            "state": tree_map(lambda _: next(it), params)}

    # -- checkpointing ---------------------------------------------------
    def __getstate__(self):
        if self._factory is None:
            raise TypeError(
                "this TorchOptimMethod wraps a prebuilt optimizer, which "
                "cannot be pickled: construct it from a factory "
                "(TorchOptimMethod(torch.optim.Adam, lr=1e-3)) for "
                "checkpoint support")
        d = super().__getstate__()
        d["_opt"] = d["_shadows"] = d["_kinds"] = None
        return d

    def __repr__(self):
        name = getattr(self._factory, "__name__", type(self._opt).__name__)
        return f"TorchOptimMethod({name}, {self._factory_kwargs!r})"


#: the JAX package's name for its bridge (``OptaxMethod``)
OptaxMethod = TorchOptimMethod
