"""Optimizer frontend and LocalOptimizer (counterpart of
``bigdl_tpu/optim/optimizer.py`` with the step of
``bigdl_tpu/parallel/plan.py::local_step``; reference
optim/Optimizer.scala:42, LocalOptimizer.scala:41).

The single-GPU training loop.  The host loop is the JAX package's
``_plan_loop``: triggers, the state table (``epoch``, ``neval``,
``loss``), epoch accounting and the epoch shuffle.  The step is its
``local_step``, eager instead of jitted:

1. under ``set_compute_dtype`` the f32 master parameters and every
   floating input are cast to the compute dtype inside the autograd
   graph (integer token ids pass untouched), so the gradients come back
   f32 through the casts; the output is cast back to f32 unless the
   criterion ``accepts_low_precision``;
2. the loss and the gradients of every parameter (autograd: through K1,
   K2, K3 and K4's Functions on the card);
3. ``optim.step`` over the parameter tree, functional, under
   ``torch.no_grad()``;
4. the gradient guard (on by default): with a non-finite loss or
   gradient the parameters and slots keep their old values and the step
   counts in ``skipped_steps``.  The decision is a device-side select,
   read back with the loss the loop fetches anyway;
5. the result written into the model's parameters in place.

Model state (BatchNorm's running statistics) lives in the model's f32
buffers, outside the parameter tree, so the compute-dtype cast never
reaches it; the forward updates it in place in training mode.  Under
the guard the step snapshots the buffers before the forward and, on a
skipped step, puts the snapshot back (``where_tree(ok, new, old)``, as
the JAX step selects its buffer tree).

Not ported yet, and refused if configured: checkpoints, validation,
retry, telemetry and elastic training.  Pad-and-mask never arises here:
one device takes every batch whole, as the JAX package's one-device
mesh does.
"""
from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np
import torch

from ..dataset.dataset import TransformedDataSet
from ..dataset.sample import MiniBatch, SampleToMiniBatch
from ..resilience.guards import tree_finite, where_tree
from ..utils.rng import next_step_seed
from ..utils.tree import tree_leaves, tree_map
from .optim_method import SGD, OptimMethod
from .trigger import Trigger, max_epoch

log = logging.getLogger("bigdl_tpu_torch")


def _unported(what: str):
    raise NotImplementedError(f"{what} is not ported yet (the training "
                              f"slice has the local loop only)")


class Optimizer:
    """Fluent training config (reference Optimizer.scala fluent API):
    ``set_optim_method``, ``set_end_when``, ``set_compute_dtype`` and
    ``set_gradient_guard``."""

    def __init__(self, model, dataset, criterion,
                 batch_size: Optional[int] = None,
                 end_trigger: Optional[Trigger] = None):
        # Samples -> MiniBatch conversion at the factory, like
        # Optimizer.apply (Optimizer.scala:330-335)
        if batch_size is not None and not _yields_minibatch(dataset):
            dataset = dataset.transform(SampleToMiniBatch(batch_size))
        self.batch_size = batch_size
        self.model = model
        self.dataset = dataset
        self.criterion = criterion
        self.optim_method: OptimMethod = SGD(learning_rate=1e-3)
        self.end_when: Trigger = end_trigger or max_epoch(1)
        # mixed precision: compute dtype for forward/backward; master
        # weights, gradients and the optimizer update stay float32
        self.compute_dtype: Optional[torch.dtype] = None
        # gradient anomaly guard: NaN/Inf steps are skipped and counted
        self.gradient_guard = True
        self.skipped_steps = 0

    def set_optim_method(self, method: OptimMethod):
        self.optim_method = method
        return self

    def set_end_when(self, trigger: Trigger):
        self.end_when = trigger
        return self

    def set_compute_dtype(self, dtype: Optional[torch.dtype]):
        """Mixed-precision training: run forward/backward in ``dtype``
        (typically ``torch.bfloat16``) while keeping float32 master
        weights and a float32 optimizer update.  ``None`` restores full
        precision."""
        if dtype is not None and not dtype.is_floating_point:
            raise ValueError(f"compute dtype {dtype} is not a float type")
        self.compute_dtype = dtype
        return self

    def set_gradient_guard(self, enabled: bool = True):
        """Enable/disable the NaN/Inf gradient guard (on by default)."""
        self.gradient_guard = bool(enabled)
        return self

    def set_validation(self, *args, **kwargs):
        _unported("validation")

    def set_checkpoint(self, *args, **kwargs):
        _unported("checkpointing")

    def set_retry_policy(self, *args, **kwargs):
        _unported("the retry policy")

    def set_telemetry(self, *args, **kwargs):
        _unported("telemetry")

    def set_train_summary(self, *args, **kwargs):
        _unported("the train summary (telemetry)")

    def set_elastic(self, *args, **kwargs):
        _unported("elastic training")

    def _check_loss_anomaly(self, skipped: bool):
        if skipped:
            self.skipped_steps += 1
            log.warning("gradient anomaly (NaN/Inf) — step skipped "
                        "(%d total); params/slots unchanged",
                        self.skipped_steps)

    def optimize(self):
        raise NotImplementedError


def _yields_minibatch(dataset) -> bool:
    try:
        probe = next(iter(dataset.data(train=False)))
    except StopIteration:
        return False
    return isinstance(probe, MiniBatch)


def _epoch_records(dataset) -> int:
    """Records per epoch: a dataset of prebuilt MiniBatches counts its
    batches' records, any other its ``size()``."""
    base = dataset
    while isinstance(base, TransformedDataSet):
        base = base.base
    items = getattr(base, "_data", None)
    if items and isinstance(items[0], MiniBatch):
        return sum(b.size() for b in items)
    return dataset.size()


def cast_floats(tree, dtype: torch.dtype):
    """Cast every floating tensor of a tree to ``dtype`` (integer
    tensors pass).  Inside an autograd graph the cast is differentiable,
    so gradients flow back in the leaves' own dtype."""
    def cast(a):
        if isinstance(a, (list, tuple)):
            return type(a)(cast(v) for v in a)
        return a.to(dtype) if a.is_floating_point() else a

    return tree_map(cast, tree)


def _device_batch(batch: MiniBatch, device: torch.device):
    """A MiniBatch's numpy arrays as tensors on ``device``."""
    def conv(v):
        if isinstance(v, (list, tuple)):
            return type(v)(conv(a) for a in v)
        return torch.as_tensor(np.asarray(v)).to(device)

    return conv(batch.get_input()), conv(batch.get_target())


def _resume_slots(optim: OptimMethod, params):
    """Reuse the optimizer's slots from an earlier run when their tree
    and leaf shapes match a fresh init; otherwise start clean."""
    fresh = optim.init_state(params)
    saved = optim._slots
    if saved is None:
        return fresh
    try:
        same = all(a.shape == b.shape for a, b in zip(
            tree_leaves(saved), tree_leaves(fresh), strict=True))
    except (KeyError, ValueError):
        same = False
    return saved if same else fresh


class LocalOptimizer(Optimizer):
    """Single-device training loop (reference
    optim/LocalOptimizer.scala:41) on the model's device."""

    def _step(self, params, slots, x, y, lr: float):
        """One training step; returns (loss, ok, new_slots) with loss
        and ok still on the device."""
        model, crit, dtype = self.model, self.criterion, self.compute_dtype
        leaves = tree_leaves(params)
        buffers = tree_leaves(model.buffer_tree())
        if self.gradient_guard:
            old_buffers = [b.clone() for b in buffers]
        with torch.enable_grad():
            p_c, x_c = params, x
            if dtype is not None:
                p_c, x_c = cast_floats(params, dtype), cast_floats(x, dtype)
            out = model.apply_fn(p_c, x_c)
            if dtype is not None \
                    and not getattr(crit, "accepts_low_precision", False):
                out = cast_floats(out, torch.float32)
            loss = crit._loss(out, y)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        with torch.no_grad():
            it = iter(torch.zeros_like(p) if g is None else g
                      for g, p in zip(grads, leaves))
            grads = tree_map(lambda _: next(it), params)
            old = tree_map(torch.Tensor.detach, params)
            new_params, new_slots = self.optim_method.step(grads, old,
                                                           slots, lr)
            if self.gradient_guard:
                ok = tree_finite(grads) & torch.isfinite(loss)
                new_params = where_tree(ok, new_params, old)
                new_slots = where_tree(ok, new_slots, slots)
                for b, b_old in zip(buffers, old_buffers):
                    b.copy_(torch.where(ok, b, b_old))
            else:
                ok = torch.ones((), dtype=torch.bool, device=loss.device)
            for p, n in zip(leaves, tree_leaves(new_params)):
                p.copy_(n)
        return loss.detach(), ok, new_slots

    def optimize(self):
        model, optim = self.model, self.optim_method
        model.train()
        params = model.param_tree()
        slots = _resume_slots(optim, tree_map(torch.Tensor.detach, params))

        state = optim.state
        state["epoch"] = state.get("epoch", 1)
        state["neval"] = state.get("neval", 1)
        state["epoch_finished"] = False
        epoch_size = _epoch_records(self.dataset)
        data_iter = self.dataset.data(train=True)
        records_this_epoch = 0
        wall_start = time.time()
        while not self.end_when(state):
            state["epoch_finished"] = False
            batch = next(data_iter)
            n_records = batch.size()
            x, y = _device_batch(batch, model.device)
            lr = optim.get_current_lr()
            # the JAX package draws a per-step key from the host RNG
            # here; drawing the same keeps its epoch shuffles
            next_step_seed()
            t0 = time.time()
            loss, ok, slots = self._step(params, slots, x, y, lr)
            # one read-back for both: the device sync of the step
            loss, ok = torch.stack([loss.float(), ok.float()]).tolist()
            train_time = time.time() - t0
            self._check_loss_anomaly(not ok)

            records_this_epoch += n_records
            state["records_this_epoch"] = records_this_epoch
            state["loss"] = loss
            log.info(
                "[Epoch %d %d/%d][Iteration %d][Wall Clock %.3fs] "
                "Train %d in %.4f seconds. Throughput is %.1f "
                "records/second. Loss is %.5f.",
                state["epoch"], records_this_epoch, epoch_size,
                state["neval"], time.time() - wall_start, n_records,
                train_time, n_records / max(train_time, 1e-9), loss)
            state["neval"] += 1
            optim.state = state

            if records_this_epoch >= epoch_size:
                state["epoch"] += 1
                state["epoch_finished"] = True
                records_this_epoch = 0
                state["records_this_epoch"] = 0
                self.dataset.shuffle()
                data_iter = self.dataset.data(train=True)

        optim._slots = slots
        model.evaluate()
        return model
