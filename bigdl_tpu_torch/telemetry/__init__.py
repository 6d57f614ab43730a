"""Unified telemetry spine: metrics registry, structured step tracing,
Perfetto export, goodput accounting, cross-host aggregation
(counterpart of ``bigdl_tpu/telemetry/``).

The modules are the JAX package's, jax-free, copied; :mod:`.perf`
counts the work of the eager step (``torch.utils.flop_counter`` plus
the kernels' own reports) where the JAX package reads XLA's cost model,
and :mod:`.device_info` has the H100's row.

* :mod:`.registry`  — thread-safe Counter/Gauge/Histogram with label
  sets, JSON snapshots + Prometheus text export, injectable clock.
* :mod:`.tracer`    — nested spans with explicit categories into a
  bounded ring buffer, exported as Chrome-trace/Perfetto JSON.
* :mod:`.goodput`   — :class:`GoodputLedger` classifying every second
  of run wall clock (productive / compile / data-stall / checkpoint /
  recovery / idle).
* :mod:`.aggregate` — hosts publish snapshots over a KV transport
  (incarnation-keyed); the leader merges a cluster view; snapshot
  directories fold into one with :func:`merge_cluster` and render
  with :func:`.report.render_report`.
* :mod:`.slog`      — structured logging entry points (the library
  never calls ``logging.basicConfig`` at import time).

:class:`Telemetry` is the driver-facing bundle: ``Optimizer
.set_telemetry(Telemetry(...))`` wires ``LocalOptimizer`` and every
rank of ``DistriOptimizer`` into the same registry, tracer and ledger.
"""
from __future__ import annotations

import time
from typing import Optional

from .aggregate import (
    collect_snapshots, merge_alerts, merge_cluster, merge_incidents,
    merge_metrics, merge_timeline, publish_snapshot,
    read_snapshot_dir, write_snapshot,
)
from .device_info import DeviceSpec, device_spec, peak_flops_per_sec
from .events import (CHANGE_EVENT_KINDS, ChangeEvent, ChangeJournal,
                     default_journal, record_change,
                     reset_default_journal)
from .incidents import Incident, IncidentEngine, IncidentPolicy
from .goodput import GOODPUT_CATEGORIES, GoodputLedger
from .metric_names import METRIC_FAMILY_NAMES
from .perf import PerfAccountant, StepCost, classify_roofline
from .publish import BackgroundPublisher
from .registry import (
    Counter, Gauge, Histogram, MetricsRegistry, default_buckets,
    default_registry, reset_default_registry,
)
from .slo import (Alert, HealthVerdict, SloEngine, SloRule,
                  TrainingHealthMonitor, default_loop_rules,
                  default_serving_rules, default_training_rules,
                  ingest_deadman_rule)
from .slog import configure_logging, get_logger
from .timeseries import MetricRecorder
from .trace_context import (REQUEST_CATEGORIES, TRACE_KV_PREFIX,
                            TailSampler, TraceContext)
from .tracer import CATEGORIES, STEP_CATEGORIES, Span, Tracer

__all__ = [
    "Alert", "BackgroundPublisher", "CATEGORIES",
    "CHANGE_EVENT_KINDS", "GOODPUT_CATEGORIES",
    "ChangeEvent", "ChangeJournal", "Counter", "DeviceSpec",
    "Gauge", "HealthVerdict", "Histogram", "Incident",
    "IncidentEngine", "IncidentPolicy", "METRIC_FAMILY_NAMES",
    "MetricRecorder", "MetricsRegistry", "GoodputLedger",
    "PerfAccountant", "REQUEST_CATEGORIES", "STEP_CATEGORIES",
    "SloEngine", "SloRule",
    "Span", "StepCost", "TRACE_KV_PREFIX", "TailSampler",
    "Telemetry", "TraceContext", "Tracer", "TrainingHealthMonitor",
    "classify_roofline", "collect_snapshots", "configure_logging",
    "default_buckets", "default_journal", "default_loop_rules",
    "default_registry",
    "default_serving_rules", "default_training_rules", "device_spec",
    "get_logger", "ingest_deadman_rule",
    "merge_alerts", "merge_cluster", "merge_incidents",
    "merge_metrics",
    "merge_timeline", "peak_flops_per_sec",
    "publish_snapshot", "read_snapshot_dir", "record_change",
    "reset_default_journal", "reset_default_registry",
    "write_snapshot",
]

#: log-spaced bounds sized for step/phase durations (100µs … ~100s)
STEP_BUCKETS = default_buckets(start=1e-4, factor=2.0, count=21)


class Telemetry:
    """The bundle the training/serving drivers speak to.

    Without arguments it adopts the process-wide default registry (so
    the resilience layer's counters land in the same snapshot), a
    fresh tracer and a fresh goodput ledger.  ``trace_every`` sets the
    tracing cadence: spans are recorded for every Nth step (1 = every
    step, the default; 0 disables span recording while keeping
    metrics + goodput).  ``snapshot_dir`` makes :meth:`write_snapshot`
    drop ``<host>.json`` payloads (read back by
    :func:`read_snapshot_dir`).
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 ledger: Optional[GoodputLedger] = None,
                 host: str = "local",
                 snapshot_dir: Optional[str] = None,
                 trace_every: int = 1,
                 perf: Optional[PerfAccountant] = None):
        self.registry = registry if registry is not None \
            else default_registry()
        self.tracer = tracer or Tracer()
        self.ledger = ledger or GoodputLedger()
        # work accounting (telemetry/perf.py): built on the same
        # registry so the mfu family lands in one snapshot
        self.perf = perf if perf is not None \
            else PerfAccountant(registry=self.registry)
        self.host = str(host)
        self.snapshot_dir = snapshot_dir
        self.trace_every = max(0, int(trace_every))
        self.incarnation = 0
        self._steps_seen = 0
        #: optional online SLO engine (telemetry/slo.py) — a
        #: TrainingHealthMonitor built over this bundle registers
        #: itself here so payload() publishes the active-alert view
        self.slo = None
        #: optional incident engine (telemetry/incidents.py) —
        #: registered the same way so payload() publishes open/recent
        #: incident bundles alongside the alerts they explain
        self.incidents = None
        r = self.registry
        # bind the CONCRETE unlabeled series (family.labels()), not the
        # family wrapper: the per-step hooks below run inside the
        # driver loop, and the family->labels->child indirection was a
        # measurable slice of per-iteration idle at millisecond step
        # times (the child exposes the same observe/inc/value/sum API)
        self.steps = r.counter(
            "bigdl_train_steps_total", "compiled train steps run"
        ).labels()
        self.records = r.counter(
            "bigdl_train_records_total", "records trained").labels()
        self.step_seconds = r.histogram(
            "bigdl_train_step_seconds",
            "compiled step wall time (post-compile)",
            bounds=STEP_BUCKETS, window=1024).labels()
        self.compile_seconds = r.histogram(
            "bigdl_train_compile_seconds",
            "first-step wall time of each attempt (kernel builds, "
            "the work count)",
            bounds=STEP_BUCKETS).labels()
        self.data_wait_seconds = r.histogram(
            "bigdl_train_data_wait_seconds",
            "host wait on the input pipeline per iteration",
            bounds=STEP_BUCKETS, window=1024).labels()
        self.h2d_seconds = r.histogram(
            "bigdl_train_host_to_device_seconds",
            "host-to-device placement (infeed sharding) per iteration",
            bounds=STEP_BUCKETS).labels()
        self.checkpoint_seconds = r.histogram(
            "bigdl_checkpoint_write_seconds",
            "checkpoint write/dispatch wall time",
            bounds=STEP_BUCKETS).labels()
        self.checkpoint_blocked_seconds = r.histogram(
            "bigdl_checkpoint_blocked_seconds",
            "critical-path seconds blocked on checkpoint back-pressure "
            "(async writer queue full)",
            bounds=STEP_BUCKETS).labels()
        self.recoveries = r.counter(
            "bigdl_recovery_windows_total",
            "fault-to-first-productive-step recovery windows").labels()
        self.skipped_steps = r.counter(
            "bigdl_guard_skipped_steps_total",
            "steps skipped by the NaN/Inf gradient guard").labels()

    # -- driver hooks ----------------------------------------------------
    def _trace_due(self) -> bool:
        return (self.trace_every > 0
                and self._steps_seen % self.trace_every == 0)

    def on_attempt_begin(self):
        """Start of an optimize attempt: the run clock starts (first
        attempt only — the ledger is idempotent)."""
        self.ledger.start()

    def on_data_wait(self, seconds: float, step: Optional[int] = None):
        """Host time spent waiting on the input pipeline."""
        seconds = max(0.0, float(seconds))
        self.data_wait_seconds.observe(seconds)
        self.ledger.add("data_stall", seconds)
        if self._trace_due():
            end = self.tracer.clock()
            self.tracer.record("data_wait", "data_wait", end - seconds,
                               seconds, step=step)

    def on_host_to_device(self, seconds: float,
                          step: Optional[int] = None):
        """Host→device placement (infeed sharding) — ledgered as part
        of the data stall, traced under its own category."""
        seconds = max(0.0, float(seconds))
        self.h2d_seconds.observe(seconds)
        self.ledger.add("data_stall", seconds)
        if self._trace_due():
            end = self.tracer.clock()
            self.tracer.record("host_to_device", "host_to_device",
                               end - seconds, seconds, step=step)

    def on_step(self, seconds: float, records: int = 0,
                step: Optional[int] = None, compiled: bool = False,
                phase_split=None, skipped: bool = False):
        """One training step completed.  ``compiled=True`` classifies it
        as compile time (the first step of every attempt); ``phase_split``
        is the optional
        :class:`~bigdl_tpu_torch.optim.profiling.PhaseSplit` attributing
        the step's device time to compute vs collective children."""
        seconds = max(0.0, float(seconds))
        if self.ledger.in_recovery:
            # the window closes where this step BEGAN — the step's own
            # seconds are attributed below, not as recovery
            rec = self.ledger.recovery_end(exclude=seconds)
            if rec and self.trace_every > 0:
                end = self.tracer.clock() - seconds
                self.tracer.record("recovery", "recovery", end - rec,
                                   rec)
        self.ledger.add("compile" if compiled else "productive", seconds)
        self.steps.inc()
        if records:
            self.records.inc(records)
        if skipped:
            self.skipped_steps.inc()
        (self.compile_seconds if compiled
         else self.step_seconds).observe(seconds)
        self.perf.on_step(seconds, compiled=compiled)
        if self._trace_due():
            end = self.tracer.clock()
            # the counted FLOPs/bytes/intensity ride on EVERY step span
            # — Perfetto traces carry the work attribution even when the
            # profiler never ran
            parent = self.tracer.record(
                "compile" if compiled else "step",
                "compile" if compiled else "step",
                end - seconds, seconds, step=step,
                **self.perf.span_args())
            if phase_split is not None and parent is not None:
                compute_s, collective_s = phase_split
                self.tracer.record("compute", "compute", parent.start,
                                   compute_s, parent=parent, step=step)
                self.tracer.record("collective", "collective",
                                   parent.start + compute_s,
                                   collective_s, parent=parent,
                                   step=step)
        self._steps_seen += 1

    def on_checkpoint(self, seconds: float, step: Optional[int] = None):
        seconds = max(0.0, float(seconds))
        self.checkpoint_seconds.observe(seconds)
        self.ledger.add("checkpoint", seconds)
        if self.trace_every > 0:
            end = self.tracer.clock()
            self.tracer.record("checkpoint", "checkpoint",
                               end - seconds, seconds, step=step)

    def on_checkpoint_blocked(self, seconds: float,
                              step: Optional[int] = None):
        """Critical-path back-pressure from the background checkpoint
        writer: the step boundary waited ``seconds`` for a previous
        async write to commit.  With async checkpointing this (plus
        the snapshot cost fed to :meth:`on_checkpoint`) is ALL the
        checkpoint time the ledger should ever see."""
        seconds = max(0.0, float(seconds))
        if seconds <= 0.0:
            return
        self.checkpoint_blocked_seconds.observe(seconds)
        self.ledger.add("checkpoint", seconds)
        if self.trace_every > 0:
            end = self.tracer.clock()
            self.tracer.record("checkpoint_blocked", "checkpoint",
                               end - seconds, seconds, step=step)

    def on_recovery_begin(self):
        """A fault was detected (retry rollback, membership change):
        wall clock is recovery until the next completed step."""
        if not self.ledger.in_recovery:
            self.recoveries.inc()
        self.ledger.recovery_begin()

    # -- export ----------------------------------------------------------
    #: newest spans carried per published payload — enough for the
    #: cluster timeline's recent window without bloating KV puts
    SPAN_EXPORT_LIMIT = 512

    def payload(self, step: Optional[int] = None) -> dict:
        """The publishable telemetry payload (what lands on the KV
        transport and in snapshot directories).  ``spans`` (the newest
        :data:`SPAN_EXPORT_LIMIT`, with a mono/wall clock anchor) is
        what ``merge_timeline`` folds into the cluster-wide Perfetto
        view."""
        return {
            "host": self.host,
            "step": step,
            "incarnation": int(self.incarnation),
            "ts": time.time(),
            "goodput": self.ledger.snapshot(),
            "metrics": self.registry.snapshot()["metrics"],
            "span_totals": self.tracer.category_totals(),
            "spans": self.tracer.export_spans(self.SPAN_EXPORT_LIMIT),
            "clock_anchor": {"mono": self.tracer.clock(),
                             "wall": time.time()},
            "perf": self.perf.payload(),
            # active/recent SLO alerts (None without an engine) — the
            # cluster fold unions these into the run-report alert table
            "alerts": (self.slo.snapshot() if self.slo is not None
                       else None),
            # open/recent incident bundles (None without an engine) —
            # merge_incidents folds them cluster-wide like alerts
            "incidents": (self.incidents.snapshot()
                          if self.incidents is not None else None),
        }

    def write_snapshot(self, directory: Optional[str] = None,
                       step: Optional[int] = None) -> Optional[str]:
        """Drop ``<host>.json`` into ``directory`` (default: the
        configured ``snapshot_dir``); no-op without one."""
        directory = directory or self.snapshot_dir
        if directory is None:
            return None
        return write_snapshot(directory, self.host, self.payload(step))

    def to_summary(self, summary, step: int):
        """Write the goodput ledger + headline counters as scalar
        events (tags ``telemetry/<field>``) through a
        ``visualization.summary.Summary`` (e.g.
        :class:`~bigdl_tpu_torch.visualization.TelemetrySummary`)."""
        snap = self.ledger.snapshot()
        summary.add_scalar("telemetry/goodput_fraction",
                           snap["productive_fraction"], step)
        summary.add_scalar("telemetry/accounted_fraction",
                           snap["accounted_fraction"], step)
        for cat, secs in snap["seconds"].items():
            summary.add_scalar(f"telemetry/{cat}_s", secs, step)
        summary.add_scalar("telemetry/steps_total", self.steps.value,
                           step)
        summary.add_scalar("telemetry/recovery_windows",
                           self.recoveries.value, step)
        return summary
