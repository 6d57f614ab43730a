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
  checkpoint at the step boundary, drains the writer and returns;
- an attached ``Telemetry`` (``set_telemetry``) takes the attempt's
  start, each data wait, each step (the first of an attempt, run once
  under the work counter of ``telemetry.perf``, as compile), each
  checkpoint and its back-pressure, each retry rollback as the start of
  a recovery window, and an end-of-run snapshot; an attached
  ``TrainingHealthMonitor`` (``set_health_monitor``) takes each step's
  loss and time.  Neither changes a loss or an update.

A checkpoint has three legs, each an atomic file with a crc32c sidecar
(``resilience.checkpoint``): ``model.N`` (the param and buffer trees
on the CPU, keyed as the module), ``optimMethod.N`` (the optim method
with its slots and state table) and ``trainState.N`` (the host RNG, the
dataset's order and the record cursor).  ``resume_from_checkpoint``
restores all three from the newest step that verifies, so the resumed
run continues on the exact next batch.  A retry restores the same way;
under FSDP a retry with no checkpoint to restore re-raises the error
that stopped the attempt (the FSDP leaves lived only as its shards).

The step is the sharding-plan engine's (``parallel/plan.py``,
``compile_step_with_plan``): each attempt derives the plan for the live
mesh (or re-binds ``set_sharding_plan``'s), reports its table, and runs
its step; ``LocalOptimizer`` and a one-rank group run the single-device
step, where FSDP is cleared.  Over a data axis (``DistriOptimizer``,
``optim/distri_optimizer.py``) the same step and loop run on every rank
of the process group, one rank a device, with the data-axis rules of the
JAX plan step (``bigdl_tpu/parallel/plan.py``):

- every rank starts from rank 0's parameters, buffers, host RNG and
  dataset order, so each walks the same global batches; rank r trains
  rows ``[r·b, (r+1)·b)`` of each, on its own device;
- a full batch: each rank's mean gradient of the replicated leaves,
  loss and floating buffers (BatchNorm statistics) go into one flat f32
  buffer, one ``all_reduce(SUM)``, then ``/N``: the global batch's mean;
- under ``set_fsdp`` a large leaf is held as this rank's shard with its
  optimizer slots, gathered on use in the step, its gradient
  reduce-scattered then ``/N``; the module's own copy is written back
  (gathered) at a checkpoint, for validation and at the end of the loop;
- a trailing batch whose record count does not divide by N is padded
  to the multiple by repeating its last record; each record's loss is
  weighted 1-real/0-pad over the global real count (an MoE term adds
  ``aux / N``), the gradients and losses are summed over ranks, and the
  buffers keep their values from before the step;
- the regularizers' gradient is added after the reduction, then the
  gradient scales; the gradient guard's decision is the same on every
  rank (``all_reduce(MIN)``); the step's dropout seed is folded with
  the rank;
- rank 0 writes checkpoints and summaries while the others wait at a
  barrier; a restore reads the same files on every rank;
- every ``bigdl.metrics.profileInterval``-th step (default 10) runs
  under ``torch.profiler`` (``optim.profiling.trace_phase_split``): its
  compute and collective time split the step's metrics and, with
  telemetry, become the step span's children; the telemetry's
  collective bytes are the plan's ``collective_bytes`` (the parameters'
  own bytes, per leaf, ``bigdl_tpu/parallel/plan.py:1730``), and the
  ``bigdl_plan_param_bytes_per_device``/``_total`` gauges what this
  rank holds and what the model has.

One rank runs no collective, so its numbers are ``LocalOptimizer``'s bit
for bit.

Not ported yet, and refused if configured: elastic training;
``"orbax"`` checkpoints; the sparse transport and relaxed synchrony
(``set_sparse_density``, ``set_sync_period``, ``set_sync_staleness``,
ROADMAP Queue 1 item 5c); pipeline parallelism
(``set_pipeline_microbatch``, item 5d).
"""
from __future__ import annotations

import contextlib
import logging
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..dataset.dataset import TransformedDataSet
from ..dataset.sample import MiniBatch, SampleToMiniBatch
from ._sharding_utils import (map_batch, maskable, mesh_device, pad_batch,
                              round_up, rows_of)
from ..nn.module import rng_scope
from ..resilience.guards import LossSpikeDetector
from ..resilience.preemption import PreemptionHandler
from ..resilience.retry import LossSpikeError, RetryPolicy
from ..utils.engine import get_property
from ..utils.rng import RNG, next_step_seed
from ..utils.tree import tree_leaves, tree_map
from .metrics import Metrics
from .optim_method import SGD, OptimMethod
from .regularizer import collect_regularizer_paths
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
        #: the data axis of a DistriOptimizer run (None: one device)
        self._axis: Optional[_DataAxis] = None
        #: the Telemetry bundle the loop feeds (set_telemetry), or None
        self.telemetry = None
        #: the TrainingHealthMonitor the loop feeds, or None
        self.health_monitor = None
        #: "trace" once a profiled step's split parsed, else None
        self.phase_source = None
        # the sharding-plan engine (parallel/plan.py): ``sharding_plan``
        # overrides the derived default rule set; ``fsdp_min_bytes``
        # arms the threshold FSDP rule (bigdl.fsdp.minBytes)
        self.sharding_plan = None
        _fsdp = get_property("bigdl.fsdp.minBytes")
        self.fsdp_min_bytes = int(_fsdp) if _fsdp else None
        #: the plan step of the last attempt (its ``table``,
        #: ``collective_bytes``, ``last_grad_norm``), or None
        self.engine = None

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
        # keep DistriOptimizer's compat aliases (max_retry, retry_window)
        # in step: a caller-mutated alias wins in its _with_retry, so a
        # snapshot of the default policy must not override this one
        if hasattr(self, "max_retry"):
            self.max_retry = policy.max_retries
        if hasattr(self, "retry_window"):
            self.retry_window = policy.window
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

    def set_telemetry(self, telemetry):
        """Attach a :class:`bigdl_tpu_torch.telemetry.Telemetry` bundle:
        the step loop then feeds the metrics registry (step/data-wait/
        checkpoint histograms, step/record counters), records
        categorized spans into the tracer (Chrome-trace/Perfetto
        export), classifies run wall clock in the goodput ledger
        (productive/compile/data-stall/checkpoint/recovery/idle) and
        counts the first step of each attempt into its PerfAccountant
        (FLOPs, bytes, MFU).  Pass ``None`` to detach."""
        self.telemetry = telemetry
        return self

    def set_health_monitor(self, monitor):
        """Attach a :class:`bigdl_tpu_torch.telemetry.TrainingHealthMonitor`:
        the step loop then feeds it per-iteration loss and step time,
        it evaluates the training SLO rule pack (loss-descent stall/
        divergence, step-time drift, goodput floor, MFU collapse) at
        its cadence, and :meth:`health_verdict` answers the live
        :class:`~bigdl_tpu_torch.telemetry.HealthVerdict`.  A monitor
        built without a telemetry bundle adopts this optimizer's at
        attach time.  Pass ``None`` to detach."""
        self.health_monitor = monitor
        if monitor is not None and monitor.telemetry is None \
                and self.telemetry is not None:
            monitor.telemetry = self.telemetry
            if getattr(self.telemetry, "slo", None) is None:
                self.telemetry.slo = monitor.engine
        return self

    def health_verdict(self):
        """The live training health verdict
        (:class:`~bigdl_tpu_torch.telemetry.HealthVerdict`), or None when
        no monitor is attached."""
        return (self.health_monitor.verdict()
                if self.health_monitor is not None else None)

    # -- the sharding-plan engine's knobs (bigdl_tpu/optim/optimizer.py:
    # 272-330; the data axis only) --------------------------------------
    def set_sharding_plan(self, plan):
        """Install an explicit :class:`~bigdl_tpu_torch.parallel.plan.Plan`
        (ordered regex rules mapping param-tree path names to partition
        specs).  ``None`` restores the derived default — module
        introspection plus the FSDP threshold rule when :meth:`set_fsdp`
        armed one.  The plan re-binds to the live mesh every attempt."""
        self.sharding_plan = plan
        return self

    def set_fsdp(self, min_bytes: Optional[int] = 1 << 20):
        """Arm FSDP parameter sharding: any parameter of at least
        ``min_bytes`` that the plan would otherwise replicate over the
        ``data`` axis is held sharded over it instead (largest divisible
        dim), with its optimizer slots, gathered on use inside the step;
        its gradient is reduce-scattered.  ``None`` disables.  (The
        ``bigdl.fsdp.minBytes`` property sets the default.)  One rank
        trains replicated: FSDP over one device is a no-op."""
        self.fsdp_min_bytes = int(min_bytes) if min_bytes else None
        return self

    def set_sparse_density(self, density: Optional[float]):
        _unported("the sparse gradient transport (set_sparse_density; "
                  "ROADMAP Queue 1 item 5c)")

    def set_sync_period(self, k: Optional[int]):
        _unported("relaxed synchrony (set_sync_period; ROADMAP Queue 1 "
                  "item 5c)")

    def set_sync_staleness(self, s: Optional[int]):
        _unported("relaxed synchrony (set_sync_staleness; ROADMAP Queue 1 "
                  "item 5c)")

    def set_pipeline_microbatch(self, n: int):
        _unported("pipeline parallelism (set_pipeline_microbatch; ROADMAP "
                  "Queue 1 item 5d)")

    def set_elastic(self, *args, **kwargs):
        _unported("elastic training")

    # -- telemetry plumbing (the JAX drivers' _tm_* hooks) --------------
    def _tm_attempt_begin(self):
        """Top of every optimize attempt: start the goodput run clock
        (idempotent — only the first attempt stamps it) and read the
        model's device for the work accounting."""
        if self.telemetry is not None:
            self.telemetry.on_attempt_begin()
            self.telemetry.perf.bind_device(self.model.device)

    def _tm_step(self, state, train_time: float, data_time: float,
                 records: int, compiled: bool = False,
                 phase_split=None, skipped: bool = False):
        """One iteration for the telemetry spine: data-wait + step time
        into the registry histograms and goodput ledger, categorized
        spans into the tracer (``compiled=True`` marks the first step of
        an attempt; ``phase_split`` attributes a profiled step's time to
        compute/collective children)."""
        tm = self.telemetry
        if tm is None:
            return
        step = state["neval"]
        if data_time > 0:
            tm.on_data_wait(data_time, step=step)
        tm.on_step(train_time, records=records, step=step,
                   compiled=compiled, phase_split=phase_split,
                   skipped=skipped)

    def _tm_finish(self, state):
        """End of a training loop: drop the host's snapshot file when a
        snapshot directory is configured."""
        if self.telemetry is not None:
            self.telemetry.write_snapshot(step=state.get("neval"))

    def _health_step(self, state, loss: float, seconds: float):
        """Per-iteration health feed (no-op without a monitor): the
        monitor samples at its own cadence and must never take down
        training."""
        hm = self.health_monitor
        if hm is None:
            return
        try:
            hm.on_step(state["neval"], loss, seconds)
        except Exception:
            log.debug("health monitor step failed", exc_info=True)

    # -- the plan step --------------------------------------------------
    def _plan_engine(self):
        """The plan step for this attempt: the data axis' mesh, or one
        device (``LocalOptimizer``, a one-rank group), where the plan is
        derived and reported and FSDP is cleared."""
        from ..parallel.plan import compile_step_with_plan

        self.engine = compile_step_with_plan(
            self.model, self.criterion, self.optim_method,
            None if self._axis is None else self._axis.mesh,
            plan=self.sharding_plan, compute_dtype=self.compute_dtype,
            guard=self.gradient_guard, fsdp_min_bytes=self.fsdp_min_bytes)
        fsdp = [n for n, row in self.engine.table.items()
                if row.endswith("[fsdp]")]
        log.info("sharding plan: %d parameters over data=%d, %d [fsdp]%s; "
                 "collective bytes a step %.0f", len(self.engine.table),
                 self.engine.n_data, len(fsdp),
                 "" if self.engine.has_fsdp or not fsdp else
                 " (cleared: one device)", self.engine.collective_bytes)
        return self.engine

    def _abandon_plan(self) -> bool:
        """After an attempt that raised: the module's released FSDP
        parameters full-size again (NaN), for a restore to overwrite.
        True when there were any."""
        return self.engine is not None and self.engine.abandon()

    def _publish_plan_metrics(self, engine, params):
        """The ``bigdl_plan_param_bytes_per_device`` (this rank's
        parameter state) and ``bigdl_plan_param_bytes_total`` (the
        model's) gauges (bigdl_tpu/optim/optimizer.py:1224-1248)."""
        from ..telemetry.registry import default_registry

        reg = (self.telemetry.registry if self.telemetry is not None
               else default_registry())
        try:
            by_dev = engine.param_bytes_by_device(params)
            if by_dev:
                reg.gauge(
                    "bigdl_plan_param_bytes_per_device",
                    "max addressable parameter bytes on one device "
                    "under the active sharding plan"
                ).set(float(max(by_dev.values())))
            reg.gauge(
                "bigdl_plan_param_bytes_total",
                "logical parameter bytes of the model"
            ).set(float(engine.total_param_bytes))
        except Exception:  # accounting must never take down training
            log.debug("plan param-bytes accounting failed", exc_info=True)

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

    def _validate(self, state, params=None):
        """Run the validation methods on ``params`` (the plan step's full
        parameters; by default the model's own), then report them (log,
        summary, the state's score)."""
        if self.validation_dataset is None or not self.validation_methods:
            return
        from .evaluator import evaluate_dataset

        t0 = time.perf_counter()
        results = evaluate_dataset(
            self.model, self.validation_dataset, self.validation_methods,
            batch_size=self.batch_size or 128,
            mesh=None if self._axis is None else self._axis.mesh,
            params=params)
        self.model.train()
        self.validation_stats.append(dict(
            step=state["neval"] - 1, seconds=time.perf_counter() - t0,
            results=[r.result() for r in results]))
        for method, result in zip(self.validation_methods, results):
            log.info("%s is %s", method.format(), result)
            if self.validation_summary is not None and self._chief():
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

        if self.checkpoint_path is None or not self._chief():
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
        tm = self.telemetry
        if tm is not None:
            if self.async_checkpoint:
                # the snapshot (serialize) cost is the checkpoint's
                # critical-path tax; back-pressure is ledgered apart
                tm.on_checkpoint(serialize_s, step=n)
                tm.on_checkpoint_blocked(blocked, step=n)
            else:
                tm.on_checkpoint(serialize_s + blocked, step=n)

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
        # background write is simply absent, which the walk-back handles;
        # over a data axis every rank reads what rank 0 committed
        self._drain_checkpoints(raise_errors=False)
        if self._axis is not None:
            self._axis.barrier()
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

    def _restore_latest(self) -> bool:
        return self.resume_from_checkpoint()

    def _with_retry(self, fn):
        """The failure-retry loop (reference DistriOptimizer.scala:
        750-816, with backoff and fatal errors never retried).  Without
        a checkpoint there is nothing to restore: the first error
        raises."""
        if self.checkpoint_path is None:
            return fn()

        def on_retry(exc, attempt):
            self.rollbacks += 1
            lost = self._abandon_plan()
            if self.telemetry is not None:
                # everything until the next completed step is recovery
                self.telemetry.on_recovery_begin()
            if self.spike_detector is not None:
                self.spike_detector.reset()
            if not self._restore_latest() and lost:
                # the FSDP leaves lived only as the failed attempt's
                # shards and no checkpoint restores them: there is no
                # state to restart from (the JAX optimizer's retry fails
                # here too, its module's arrays donated to the step)
                raise exc

        return self.retry_policy.run(fn, on_retry=on_retry)

    def _preemption_scope(self):
        if not self.handle_preemption:
            self._preemption = None
            return contextlib.nullcontext()
        self._preemption = PreemptionHandler()
        return self._preemption

    def _preempted(self) -> bool:
        stop = self._preemption is not None and self._preemption.should_stop
        if self._axis is not None and self.handle_preemption:
            # a signal on any rank stops every rank at the same step
            stop = self._axis.any(stop)
        return stop

    # -- the step and the loop (LocalOptimizer and DistriOptimizer) -----
    def _chief(self) -> bool:
        """Rank 0 of the data axis, or the one process of a local run:
        the process that writes checkpoints and summaries."""
        return self._axis is None or self._axis.rank == 0

    def _loop(self):
        model, optim, axis = self.model, self.optim_method, self._axis
        self._tm_attempt_begin()
        model.train()
        if axis is not None:
            # every rank starts from rank 0's weights, host RNG and
            # dataset order, so each walks the same global batches
            axis.sync_start(model, self.dataset)
        # the plan step for this attempt's mesh: the plan re-binds to the
        # live mesh each attempt; FSDP leaves become this rank's shards
        engine = self._plan_engine()
        params, slots = engine.init_state()
        self._publish_plan_metrics(engine, params)
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
        tm = self.telemetry
        # the first step of the attempt runs under the work counter and
        # is booked as compile (the kernels build on their first call)
        first_step = True
        # a data axis profiles every profile_interval-th step past the
        # first (the JAX driver profiles its multi-device meshes)
        profile_interval = (int(get_property(
            "bigdl.metrics.profileInterval", 10)) if axis is not None else 0)
        compute_ratio = None   # the last profiled step's compute share
        # the plan's wire estimate (bigdl_tpu/parallel/plan.py:1730)
        collective_bytes = engine.collective_bytes
        while not self.end_when(state):
            state["epoch_finished"] = False
            t_fetch = time.time()
            batch = next(data_iter)
            n_records = batch.size()
            t_place = time.time()
            weight = None
            if axis is None:
                x, y = _device_batch(batch, model.device)
            else:
                x, y, weight = axis.place(batch, model.device)
            fetch_time = time.time() - t_fetch
            # one device: the placement is part of the data wait; over a
            # data axis it is ledgered apart, as the JAX driver's h2d
            data_time = fetch_time
            if axis is not None:
                data_time = t_place - t_fetch
                if tm is not None:
                    tm.on_host_to_device(time.time() - t_place,
                                         step=state["neval"])
            lr = optim.get_current_lr()
            # the JAX package draws a per-step key from the host RNG
            # here; the same draw seeds the step's generator, which every
            # random layer of the forward (dropout) draws from in order,
            # and keeps the JAX package's epoch shuffles.  Over a data
            # axis the draw is folded with the rank, so the ranks' masks
            # differ (bigdl_tpu/parallel/plan.py:1565-1569)
            seed = next_step_seed()
            if axis is not None:
                seed = axis.fold(seed)
            step_gen = torch.Generator(device=model.device).manual_seed(seed)
            profiled = (profile_interval > 0 and state["neval"] > 1
                        and state["neval"] % profile_interval == 0
                        and weight is None and not first_step)

            def run_step():
                with rng_scope(step_gen):
                    return engine.step(params, slots, x, y, lr, reg_paths,
                                       scales, weight)

            def read_back(out):
                # one read-back for both: the device sync of the step
                return (*torch.stack([out[0].float(),
                                      out[1].float()]).tolist(), out[2])

            t0 = time.time()
            trace_split = None
            if first_step and tm is not None:
                # the work counter sees the step, not the read-back
                out, _ = tm.perf.analyze_step(
                    run_step, collective_bytes=collective_bytes)
                loss, ok, slots = read_back(out)
            elif profiled:
                from .profiling import trace_phase_split

                step_out = []
                trace_split = trace_phase_split(
                    lambda: step_out.append(read_back(run_step())),
                    model.device)
                loss, ok, slots = step_out[0]
            else:
                loss, ok, slots = read_back(run_step())
            train_time = time.time() - t0
            if tm is not None:
                self._tm_step(state, train_time, data_time,
                              n_records if axis is None
                              else axis.records(n_records, weight),
                              compiled=first_step, phase_split=trace_split,
                              skipped=not ok)
            first_step = False
            self._check_loss_anomaly(loss, not ok)
            self._health_step(state, loss, train_time)

            records_this_epoch += n_records
            state["records_this_epoch"] = records_this_epoch
            state["loss"] = loss
            # metric-name contract (reference DistriOptimizer.scala:
            # 146-151): profiled steps pin the compute/aggregate split,
            # the last one measured attributes the steps in between
            if trace_split is not None:
                c_s, agg_s = trace_split
                compute_ratio = c_s / max(c_s + agg_s, 1e-12)
                self.phase_source = "trace"
            ratio = 1.0 if compute_ratio is None else compute_ratio
            self.metrics.add("computing time average", train_time * ratio)
            self.metrics.add("aggregate gradient time",
                             train_time * (1.0 - ratio))
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
            if self._chief():
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
            preempted = self._preempted()
            if do_validate:
                self._validate(state, engine.eval_params(params))
            if do_checkpoint or preempted:
                # the full trees into the module and the optim method
                # (FSDP leaves gathered) before rank 0 serializes them
                engine.sync_to_model(params, slots)
                self._write_pickle_checkpoint(state)
                engine.release()
                if axis is not None:
                    # rank 0 writes; the others wait for it here
                    axis.barrier()
            if preempted:
                self._drain_checkpoints()
                log.warning("preemption requested — checkpointed at "
                            "iteration %d; exiting resumable",
                            state["neval"] - 1)
                break

        engine.sync_to_model(params, slots)
        model.evaluate()
        # every triggered checkpoint is durable, or its write error
        # surfaces here, into the retry loop
        self._drain_checkpoints()
        if axis is not None:
            axis.barrier()
        self._tm_finish(state)
        return model

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


def _weighted_loss(crit, out, y, w, n_real: float):
    """The sum of each record's loss (the criterion on that record
    alone) times its weight, over ``n_real``: pad-and-mask's loss
    (``bigdl_tpu/parallel/plan.py:1578-1588``, a vmap there)."""
    def record(tree, i):
        return map_batch(lambda a: a[i:i + 1], tree)

    per = torch.stack([crit._loss(record(out, i), record(y, i))
                       for i in range(w.shape[0])])
    return (per * w).sum() / n_real


class _DataAxis:
    """The data axis of a DistriOptimizer run over a ``("data",)`` mesh:
    this rank's rows of each global batch and the loop's collectives
    (the start, the barrier, the preemption vote); the step's are the
    plan step's (``parallel/plan.py``)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.group = mesh.get_group()
        self.size = mesh.size()
        self.rank = mesh.get_local_rank()

    def sync_start(self, model, dataset):
        """Rank 0's parameters, buffers, host RNG and dataset order on
        every rank (``ModelBroadcast``'s broadcast of the trees)."""
        from ..parallel.broadcast import broadcast_tree_

        if self.size == 1:
            return
        broadcast_tree_(model.param_tree(), group=self.group)
        broadcast_tree_(model.buffer_tree(), group=self.group)
        host = [dict(rng=RNG().state_dict(), dataset=dataset.state_dict())]
        dist.broadcast_object_list(host, src=0, group=self.group)
        RNG().load_state_dict(host[0]["rng"])
        dataset.load_state_dict(host[0]["dataset"])

    def place(self, batch: MiniBatch, device: torch.device):
        """This rank's rows ``[r·b, (r+1)·b)`` of a global batch on
        ``device``, and for a batch whose record count does not divide
        by the axis, padded to the multiple, ``(w, n_real)`` (else None):
        this rank's record weights and the global real count."""
        n = batch.size()
        x, y = batch.get_input(), batch.get_target()
        weight = None
        if n % self.size:
            if not maskable(y, n):
                raise ValueError(
                    f"training got a batch of {n} records, not a multiple "
                    f"of the data axis {self.size}, but the targets are "
                    "not record-leading arrays for pad-and-mask; size the "
                    f"batches to a multiple of {self.size}")
            x, y, w = pad_batch(x, y, n, round_up(n, self.size))
            weight = (rows_of(w, self.rank, self.size, device), float(n))
        return (rows_of(x, self.rank, self.size, device),
                rows_of(y, self.rank, self.size, device), weight)

    def records(self, n: int, weight) -> int:
        """The records of a global batch of ``n`` this rank trained (its
        real rows), so the ranks' telemetry counts sum to the batch."""
        if weight is None:
            return n // self.size
        return int(weight[0].sum().item())

    def any(self, flag: bool) -> bool:
        t = torch.tensor([int(flag)], dtype=torch.int32,
                         device=mesh_device(self.mesh))
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return bool(t.item())

    def fold(self, seed: int) -> int:
        """The step's seed folded with the rank (itself on one rank)."""
        if self.size == 1:
            return seed
        return int(np.random.SeedSequence([seed, self.rank])
                   .generate_state(1)[0]) & 0x7FFFFFFF

    def barrier(self):
        if self.size == 1:
            return
        kw = ({"device_ids": [torch.cuda.current_device()]}
              if self.mesh.device_type == "cuda" else {})
        dist.barrier(group=self.group, **kw)


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

    def optimize(self):
        self._warn_drop_knobs_if_inert()
        try:
            with self._preemption_scope():
                return self._with_retry(self._loop)
        finally:
            self._abandon_plan()
            self._shutdown_async_writer()
