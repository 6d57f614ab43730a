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
   K2, K3 and K4's Functions on the card); an MoE model's auxiliary
   terms (``coef · aux`` of each ``MoEFFN`` with ``aux_loss_coef > 0``,
   handed over live by ``parallel.moe.capture_aux``) join the
   criterion's loss before the gradient, so the reported loss includes
   them (``bigdl_tpu/parallel/plan.py:1575``);
3. the regularizers' penalty (``optim/regularizer.py``, taken on the
   f32 master parameters): its gradient added to the loss gradient, the
   penalty to the logged loss; then every gradient times its leaf of
   ``model.gradient_scale_tree()`` (``set_scale_w``/``set_scale_b``),
   in the JAX step's order (``bigdl_tpu/parallel/plan.py:1599-1610``);
4. ``optim.step`` over the parameter tree, functional, under
   ``torch.no_grad()``;
5. the gradient guard (on by default): with a non-finite loss or
   gradient the parameters and slots keep their old values and the step
   counts in ``skipped_steps``.  The decision is a device-side select,
   read back with the loss the loop fetches anyway;
6. the result written into the model's parameters in place.

Model state (BatchNorm's running statistics, an MoE layer's last
``aux_loss``) lives in the model's f32
buffers, outside the parameter tree, so the compute-dtype cast never
reaches it; the forward updates it in place in training mode.  Under
the guard the step snapshots the buffers before the forward and, on a
skipped step, puts the snapshot back (``where_tree(ok, new, old)``, as
the JAX step selects its buffer tree).

Around the step the loop runs the JAX ``_plan_loop``'s host side:

- the loss-spike detector (``set_loss_spike_guard``) reads the loss the
  loop already fetched; its ``LossSpikeError`` reaches ``_with_retry``,
  which drains the checkpoint writer, restores the newest verified
  checkpoint and re-enters the loop (``rollbacks`` counts restores);
- the train summary takes the loss, the throughput, the learning rate
  and the skipped-step count each iteration (no device read of its own);
- after each iteration the validation trigger and then the checkpoint
  trigger are each evaluated once: validation runs the methods on the
  live parameters (``optim.evaluator``), a checkpoint serializes its
  three legs at the step boundary and hands them to the background
  writer (``set_async_checkpoint``, on by default) or writes them at
  once;
- a preemption request (``set_preemption_handling``) writes a
  checkpoint at the step boundary, drains the writer and returns.

A checkpoint has three legs, each an atomic file with a crc32c sidecar
(``resilience.checkpoint``): ``model.N`` (the param and buffer trees
on the CPU, keyed as the module), ``optimMethod.N`` (the optim method
with its slots and state table) and ``trainState.N`` (the host RNG, the
dataset's order and the record cursor).  ``resume_from_checkpoint``
restores all three from the newest step that verifies, so the resumed
run continues on the exact next batch.

Not ported yet, and refused if configured: telemetry and elastic
training; ``"orbax"`` checkpoints.  Pad-and-mask never arises here: one
device takes every batch whole, as the JAX package's one-device mesh
does.
"""
from __future__ import annotations

import contextlib
import logging
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..dataset.dataset import TransformedDataSet
from ..dataset.sample import MiniBatch, SampleToMiniBatch
from ..nn.module import rng_scope
from ..parallel.moe import capture_aux
from ..resilience.guards import LossSpikeDetector, tree_finite, where_tree
from ..resilience.preemption import PreemptionHandler
from ..resilience.retry import LossSpikeError, RetryPolicy
from ..utils.rng import RNG, next_step_seed
from ..utils.tree import tree_leaves, tree_map
from .metrics import Metrics
from .optim_method import SGD, OptimMethod
from .regularizer import collect_regularizer_paths, regularizer_loss
from .trigger import Trigger, max_epoch, max_iteration

log = logging.getLogger("bigdl_tpu_torch")


def _unported(what: str):
    raise NotImplementedError(f"{what} is not ported to bigdl_tpu_torch "
                              f"yet")


class Optimizer:
    """Fluent training config (reference Optimizer.scala fluent API):
    the optim method, the end trigger, the compute dtype, the gradient
    guard, validation, checkpoints, summaries and the resilience
    settings of the JAX ``Optimizer``."""

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
        self.checkpoint_path: Optional[str] = None
        self.checkpoint_trigger: Optional[Trigger] = None
        self.checkpoint_format = "pickle"
        self.is_overwrite = False
        self.validation_trigger: Optional[Trigger] = None
        self.validation_dataset = None
        self.validation_methods: Sequence = ()
        self.train_summary = None
        self.validation_summary = None
        self.metrics = Metrics()
        # gradient anomaly guard: NaN/Inf steps are skipped and counted
        self.gradient_guard = True
        # loss-spike rollback: off unless configured (it needs a
        # checkpoint to roll back to)
        self.spike_detector: Optional[LossSpikeDetector] = None
        self.retry_policy = RetryPolicy.from_properties()
        # SIGTERM/SIGINT -> checkpoint at the next step boundary and a
        # resumable return (off by default: signal handlers are the
        # application's decision)
        self.handle_preemption = False
        self._preemption: Optional[PreemptionHandler] = None
        # reference straggler knobs (Optimizer.scala:229-243): kept, and
        # inert with a warning on one device (no straggler to drop)
        self.drop_percentage = 0.0
        self.max_drop_percentage = 0.0
        self._drop_warmup = 200
        self.compute_threshold_batchsize = 100
        # background snapshot-then-write checkpoints (on by default)
        self.async_checkpoint = True
        self._ckpt_writer = None
        self._ckpt_queue_depth = 1
        # records already trained in the interrupted epoch: set by
        # resume_from_checkpoint, consumed once by the loop
        self._resume_cursor: Optional[int] = None
        self.skipped_steps = 0   # anomalous steps skipped by the guard
        self.rollbacks = 0       # checkpoint restores done by the retry
        #: per checkpoint: step, bytes by leg, serialize seconds (on the
        #: step's path) and submit seconds blocked on the writer
        self.checkpoint_stats: list = []
        #: the background writer's committed jobs and write seconds,
        #: summed over the writers this optimizer closed
        self.checkpoint_writes = 0
        self.checkpoint_write_seconds = 0.0
        #: per validation trigger: step, seconds, each method's result
        self.validation_stats: list = []

    # -- fluent config (Optimizer.scala:98-243) -------------------------
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

    def set_validation(self, trigger: Trigger, dataset, v_methods,
                       batch_size: Optional[int] = None):
        """Run ``v_methods`` over ``dataset`` whenever ``trigger``
        fires (Samples are batched by ``batch_size``)."""
        if batch_size is not None and not _yields_minibatch(dataset):
            dataset = dataset.transform(SampleToMiniBatch(batch_size))
        self.validation_trigger = trigger
        self.validation_dataset = dataset
        self.validation_methods = list(v_methods)
        return self

    def set_checkpoint(self, path: str, trigger: Trigger,
                       format: str = "pickle"):
        """Write verified pickle checkpoints (``model.N``,
        ``optimMethod.N``, ``trainState.N``) under ``path`` whenever
        ``trigger`` fires (reference DistriOptimizer.scala:394-416)."""
        if format == "orbax":
            _unported("orbax checkpoints (format='orbax')")
        if format != "pickle":
            raise ValueError(f"checkpoint format {format!r} not in "
                             "('pickle', 'orbax')")
        self.checkpoint_path = path
        self.checkpoint_trigger = trigger
        self.checkpoint_format = format
        return self

    def overwrite_checkpoint(self):
        self.is_overwrite = True
        return self

    def set_train_summary(self, summary):
        self.train_summary = summary
        return self

    def set_validation_summary(self, summary):
        self.validation_summary = summary
        return self

    # -- resilience config ---------------------------------------------
    def set_gradient_guard(self, enabled: bool = True):
        """Enable/disable the NaN/Inf gradient guard (on by default)."""
        self.gradient_guard = bool(enabled)
        return self

    def set_loss_spike_guard(self, k: Optional[int] = 3, ratio: float = 2.0,
                             warmup: int = 10):
        """Roll back to the last good checkpoint after ``k`` consecutive
        iterations whose loss exceeds ``ratio`` times its running
        average (``resilience.guards.LossSpikeDetector``); ``k=None``
        disables.  Without ``set_checkpoint`` a trip only logs."""
        self.spike_detector = (None if k is None else
                               LossSpikeDetector(k=k, ratio=ratio,
                                                 warmup=warmup))
        return self

    def set_retry_policy(self, policy: RetryPolicy):
        """Replace the failure retry policy (default: built from the
        ``bigdl.failure.*`` properties)."""
        self.retry_policy = policy
        return self

    def set_async_checkpoint(self, enabled: bool = True,
                             queue_depth: int = 1):
        """Background snapshot-then-write checkpoints (on by default):
        the legs are serialized at the step boundary, so the bytes are
        those of a synchronous write, and one writer thread does the
        atomic crc32c writes, with back-pressure at ``queue_depth``
        pending checkpoints."""
        self.async_checkpoint = bool(enabled)
        if self._ckpt_writer is not None \
                and self._ckpt_writer.queue_depth != int(queue_depth):
            self._close_writer()
        self._ckpt_queue_depth = max(1, int(queue_depth))
        return self

    def set_preemption_handling(self, enabled: bool = True):
        """Install SIGTERM/SIGINT handlers for the duration of
        ``optimize()``: on a signal, finish the step, write a checkpoint
        (when a path is set) and return; the next run resumes with
        ``resume_from_checkpoint``."""
        self.handle_preemption = bool(enabled)
        return self

    def set_drop_module_property(self, drop_percentage, max_drop_percentage,
                                 batch_size=100, warmup_iteration=200):
        """Straggler-drop knobs (reference Optimizer.scala:229-243).  The
        JAX package hands them to its elastic straggler policy; one
        device has no straggler to drop, so ``optimize()`` warns that
        they are set and do nothing."""
        self.drop_percentage = float(drop_percentage)
        self.max_drop_percentage = float(max_drop_percentage)
        self.compute_threshold_batchsize = batch_size
        self._drop_warmup = int(warmup_iteration)
        return self

    def _warn_drop_knobs_if_inert(self):
        if self.drop_percentage:
            log.warning(
                "straggler-drop knobs set (drop_percentage=%.2f, "
                "max_drop_percentage=%.2f) on a single-device run: there "
                "is no straggler to drop", self.drop_percentage,
                self.max_drop_percentage)

    def train_more(self, n_steps: int):
        """Continue training for ``n_steps`` more iterations: the optim
        method's state table carries ``neval``/``epoch`` across calls,
        so each slice resumes where the last one stopped; this extends
        the end trigger by ``n_steps`` completed iterations and
        re-enters ``optimize()``."""
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        done = int(self.optim_method.state.get("neval", 1)) - 1
        self.set_end_when(max_iteration(done + int(n_steps)))
        return self.optimize()

    def set_telemetry(self, *args, **kwargs):
        _unported("telemetry")

    def set_elastic(self, *args, **kwargs):
        _unported("elastic training")

    # -- host-side loop pieces -----------------------------------------
    @staticmethod
    def _should(trigger, state) -> bool:
        return trigger is not None and trigger(state)

    def _check_loss_anomaly(self, loss: float, skipped: bool):
        """Count guard skips, feed the spike detector, and raise the
        retryable LossSpikeError when it trips."""
        if skipped:
            self.skipped_steps += 1
            log.warning("gradient anomaly (NaN/Inf) — step skipped "
                        "(%d total); params/slots unchanged",
                        self.skipped_steps)
            return
        if self.spike_detector is not None and \
                self.spike_detector.update(loss):
            if self.checkpoint_path is None:
                log.error("loss spike detected (loss %.6g) but no "
                          "checkpoint is configured — cannot roll back; "
                          "continuing", loss)
                return
            raise LossSpikeError(
                f"training loss diverged (loss {loss:.6g} after "
                f"{self.spike_detector.k} consecutive spikes) — rolling "
                "back to the last good checkpoint")

    def _summarize_step(self, state, loss: float, lr: float,
                        throughput: float):
        s = self.train_summary
        if s is None:
            return
        step = state["neval"]
        s.add_scalar("Loss", loss, step)
        s.add_scalar("Throughput", throughput, step)
        if "LearningRate" in getattr(s, "triggers", {}):
            s.add_scalar("LearningRate", lr, step)
        if self.gradient_guard:
            s.add_scalar("SkippedSteps", float(self.skipped_steps), step)

    def _validate(self, state):
        """Run the validation methods on the live parameters, then
        report them (log, summary, the state's score)."""
        if self.validation_dataset is None or not self.validation_methods:
            return
        from .evaluator import evaluate_dataset

        t0 = time.perf_counter()
        results = evaluate_dataset(self.model, self.validation_dataset,
                                   self.validation_methods,
                                   batch_size=self.batch_size or 128)
        self.model.train()
        self.validation_stats.append(dict(
            step=state["neval"] - 1, seconds=time.perf_counter() - t0,
            results=[r.result() for r in results]))
        for method, result in zip(self.validation_methods, results):
            log.info("%s is %s", method.format(), result)
            if self.validation_summary is not None:
                self.validation_summary.add_scalar(
                    method.format(), result.result()[0], state["neval"] - 1)
            if method.format() in ("Top1Accuracy", "Top5Accuracy"):
                state["score"] = result.result()[0]

    # -- checkpoints -----------------------------------------------------
    def _model_leg(self) -> dict:
        """The model leg: the param and buffer trees (serialized on the
        CPU), keyed as the module."""
        return {"params": self.model.param_tree(),
                "buffers": self.model.buffer_tree()}

    def _train_state_dict(self, state) -> dict:
        """The non-parameter half of total training state: the host RNG
        stream (per-step seeds, shuffles) and the input pipeline's
        order and cursor."""
        return {"version": 1,
                "rng": RNG().state_dict(),
                "dataset": self.dataset.state_dict(),
                "records_this_epoch": int(state.get("records_this_epoch",
                                                    0))}

    def _apply_train_state(self, ts: dict):
        if not isinstance(ts, dict) or "rng" not in ts:
            return
        RNG().load_state_dict(ts["rng"])
        self.dataset.load_state_dict(ts.get("dataset") or {})
        self._resume_cursor = int(ts.get("records_this_epoch", 0))

    def _consume_resume_cursor(self, data_iter, epoch_size: int) -> int:
        """Fast-forward a fresh epoch iterator past the records the
        interrupted run already trained (the order is restored state,
        so the skipped batches are the ones trained).  Returns the
        restored records-this-epoch count."""
        cursor, self._resume_cursor = self._resume_cursor, None
        if not cursor:
            return 0
        if cursor >= epoch_size:
            log.warning("resume cursor %d >= epoch size %d — starting "
                        "the epoch from its first record", cursor,
                        epoch_size)
            return 0
        skipped = 0
        while skipped < cursor:
            skipped += next(data_iter).size()
        log.info("resumed input pipeline at record %d/%d of the "
                 "interrupted epoch", skipped, epoch_size)
        return skipped

    def _checkpoint_writer(self):
        from ..resilience.async_checkpoint import AsyncCheckpointWriter

        if self._ckpt_writer is None:
            self._ckpt_writer = AsyncCheckpointWriter(
                queue_depth=self._ckpt_queue_depth)
        return self._ckpt_writer

    def _drain_checkpoints(self, raise_errors: bool = True):
        """Barrier: every submitted checkpoint is committed, or its write
        error raises here, on the training thread."""
        if self._ckpt_writer is not None:
            self._ckpt_writer.drain(raise_errors=raise_errors)

    def _close_writer(self):
        w, self._ckpt_writer = self._ckpt_writer, None
        if w is None:
            return
        try:
            w.close()
        finally:
            self.checkpoint_writes += w.writes
            self.checkpoint_write_seconds += w.write_seconds

    def _shutdown_async_writer(self):
        """Best-effort writer close on the way out of ``optimize()``;
        never raises (an abnormal exit's own exception must not be
        masked; on the normal path failures surfaced at the drains)."""
        try:
            self._close_writer()
        except Exception:
            log.exception("async checkpoint writer close failed")

    def _write_pickle_checkpoint(self, state):
        """Serialize the three legs at the step boundary, then write
        them atomically with crc32c sidecars: on the background writer
        (``async_checkpoint``) or here."""
        from ..utils import file_io

        if self.checkpoint_path is None:
            return
        n = state["neval"] - 1
        suffix = "" if self.is_overwrite else f".{n}"
        t0 = time.perf_counter()
        files = tuple(
            (file_io.join(self.checkpoint_path, f"{name}{suffix}"),
             file_io.serialize(obj))
            for name, obj in (("model", self._model_leg()),
                              ("optimMethod", self.optim_method),
                              ("trainState", self._train_state_dict(state))))
        serialize_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        if self.async_checkpoint:
            blocked = self._checkpoint_writer().submit(n, files)
        else:
            for path, data in files:
                file_io.save_bytes(data, path, atomic=True, checksum=True)
            blocked = time.perf_counter() - t0
        self.checkpoint_stats.append(dict(
            step=n, bytes={path.rsplit("/", 1)[-1]: len(data)
                           for path, data in files},
            serialize_s=serialize_s, blocked_s=blocked,
            async_write=self.async_checkpoint))

    def resume_from_checkpoint(self, step: Optional[int] = None) -> bool:
        """Restore the newest verified checkpoint under
        ``checkpoint_path`` into the live model and optimizer; False when
        there is nothing to restore.  The restore is total: the
        ``trainState`` leg brings back the host RNG and the input
        pipeline's order and cursor, so the run continues on the exact
        next batch.  ``step`` pins the restore to the newest checkpoint
        at or below it; optimMethod and trainState are pinned to the
        step the model came from."""
        from ..resilience.checkpoint import verify_and_load_latest
        from ..utils.file_io import to_device

        # a restore must see every checkpoint already triggered; a failed
        # background write is simply absent, which the walk-back handles
        self._drain_checkpoints(raise_errors=False)
        restored_any = False
        leg, path = verify_and_load_latest(self.checkpoint_path, "model",
                                           max_step=step)
        pin = step
        if leg is not None:
            self.model.set_param_tree(leg["params"])
            self.model.set_buffer_tree(leg["buffers"])
            restored_any = True
            tail = path.rsplit(".", 1)[-1] if path else ""
            if tail.isdigit():
                pin = int(tail)
        om, _ = verify_and_load_latest(self.checkpoint_path, "optimMethod",
                                       max_step=pin)
        if om is not None:
            if om._slots is not None:
                om._slots = to_device(om._slots, self.model.device)
            self.optim_method = om
            restored_any = True
        ts, _ = verify_and_load_latest(self.checkpoint_path, "trainState",
                                       max_step=pin)
        if ts is not None:
            self._apply_train_state(ts)
        return restored_any

    def _restore_latest(self):
        self.resume_from_checkpoint()

    def _with_retry(self, fn):
        """The failure-retry loop (reference DistriOptimizer.scala:
        750-816, with backoff and fatal errors never retried).  Without
        a checkpoint there is nothing to restore: the first error
        raises."""
        if self.checkpoint_path is None:
            return fn()

        def on_retry(exc, attempt):
            self.rollbacks += 1
            if self.spike_detector is not None:
                self.spike_detector.reset()
            self._restore_latest()

        return self.retry_policy.run(fn, on_retry=on_retry)

    def _preemption_scope(self):
        if not self.handle_preemption:
            self._preemption = None
            return contextlib.nullcontext()
        self._preemption = PreemptionHandler()
        return self._preemption

    def _preempted(self) -> bool:
        return self._preemption is not None and self._preemption.should_stop

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

    def _step(self, params, slots, x, y, lr: float, reg_paths=(),
              scales=None):
        """One training step; returns (loss, ok, new_slots) with loss
        and ok still on the device.  ``reg_paths``: the model's
        regularizers (``collect_regularizer_paths``); ``scales``: the
        leaves of its gradient scale tree, or None when all are 1."""
        model, crit, dtype = self.model, self.criterion, self.compute_dtype
        leaves = tree_leaves(params)
        buffers = tree_leaves(model.buffer_tree())
        if self.gradient_guard:
            old_buffers = [b.clone() for b in buffers]
        with torch.enable_grad():
            p_c, x_c = params, x
            if dtype is not None:
                p_c, x_c = cast_floats(params, dtype), cast_floats(x, dtype)
            with capture_aux() as aux_terms:
                out = model.apply_fn(p_c, x_c)
            if dtype is not None \
                    and not getattr(crit, "accepts_low_precision", False):
                out = cast_floats(out, torch.float32)
            loss = crit._loss(out, y)
            for coef, aux in aux_terms:
                loss = loss + coef * aux
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            # the penalty on the f32 masters, after the loss gradient
            reg = regularizer_loss(params, reg_paths)
            if torch.is_tensor(reg):
                reg_g = torch.autograd.grad(reg, leaves, allow_unused=True)
                grads = [r if g is None else g if r is None else g + r
                         for g, r in zip(grads, reg_g)]
                loss = loss + reg.detach()
        with torch.no_grad():
            grads = [torch.zeros_like(p) if g is None else g
                     for g, p in zip(grads, leaves)]
            if scales is not None:
                grads = [g if s == 1.0 else g * s
                         for g, s in zip(grads, scales)]
            it = iter(grads)
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
        self._warn_drop_knobs_if_inert()
        try:
            with self._preemption_scope():
                return self._with_retry(self._loop)
        finally:
            self._shutdown_async_writer()

    def _loop(self):
        model, optim = self.model, self.optim_method
        model.train()
        params = model.param_tree()
        slots = _resume_slots(optim, tree_map(torch.Tensor.detach, params))
        reg_paths = list(collect_regularizer_paths(model))
        scales = tree_leaves(model.gradient_scale_tree())
        if all(s == 1.0 for s in scales):
            scales = None

        state = optim.state
        state["epoch"] = state.get("epoch", 1)
        state["neval"] = state.get("neval", 1)
        state["epoch_finished"] = False
        epoch_size = _epoch_records(self.dataset)
        data_iter = self.dataset.data(train=True)
        # a total-state resume continues mid-epoch on the exact next batch
        records_this_epoch = self._consume_resume_cursor(data_iter,
                                                         epoch_size)
        wall_start = time.time()
        while not self.end_when(state):
            state["epoch_finished"] = False
            t_fetch = time.time()
            batch = next(data_iter)
            n_records = batch.size()
            x, y = _device_batch(batch, model.device)
            fetch_time = time.time() - t_fetch
            lr = optim.get_current_lr()
            # the JAX package draws a per-step key from the host RNG
            # here; the same draw seeds the step's generator, which every
            # random layer of the forward (dropout) draws from in order,
            # and keeps the JAX package's epoch shuffles
            step_gen = torch.Generator(device=model.device).manual_seed(
                next_step_seed())
            t0 = time.time()
            with rng_scope(step_gen):
                loss, ok, slots = self._step(params, slots, x, y, lr,
                                             reg_paths, scales)
            # one read-back for both: the device sync of the step
            loss, ok = torch.stack([loss.float(), ok.float()]).tolist()
            train_time = time.time() - t0
            self._check_loss_anomaly(loss, not ok)

            records_this_epoch += n_records
            state["records_this_epoch"] = records_this_epoch
            state["loss"] = loss
            self.metrics.add("computing time average", train_time)
            self.metrics.add("aggregate gradient time", 0.0)
            self.metrics.add("get weights average", fetch_time)
            self.metrics.add("data fetch time", fetch_time)
            throughput = n_records / max(train_time + fetch_time, 1e-9)
            log.info(
                "[Epoch %d %d/%d][Iteration %d][Wall Clock %.3fs] "
                "Train %d in %.4f seconds. Throughput is %.1f "
                "records/second. Loss is %.5f.",
                state["epoch"], records_this_epoch, epoch_size,
                state["neval"], time.time() - wall_start, n_records,
                train_time + fetch_time, throughput, loss)
            self._summarize_step(state, loss, lr, throughput)
            state["neval"] += 1
            optim.state = state

            if records_this_epoch >= epoch_size:
                state["epoch"] += 1
                state["epoch_finished"] = True
                records_this_epoch = 0
                state["records_this_epoch"] = 0
                self.dataset.shuffle()
                data_iter = self.dataset.data(train=True)

            # each trigger evaluated once per iteration (a stateful user
            # trigger must not see a second call): validate, checkpoint
            do_validate = self._should(self.validation_trigger, state)
            do_checkpoint = self._should(self.checkpoint_trigger, state)
            if do_validate:
                self._validate(state)
            if do_checkpoint or self._preempted():
                optim._slots = slots
                self._write_pickle_checkpoint(state)
            if self._preempted():
                self._drain_checkpoints()
                log.warning("preemption requested — checkpointed at "
                            "iteration %d; exiting resumable",
                            state["neval"] - 1)
                break

        optim._slots = slots
        model.evaluate()
        # every triggered checkpoint is durable, or its write error
        # surfaces here, into the retry loop
        self._drain_checkpoints()
        return model
