"""Health-gated continuous-learning production loop (docs/continuous.md)
(counterpart of ``bigdl_tpu/loop/continuous.py``).

One driver owns the full production cycle::

    ingest → train slice → serve → (gate → deploy → watch) → audit
      │         │            │         │        │       │
      │         │            │         │        │       └ burn-rate alert
      │         │            │         │        │         → fleet rollback
      │         │            │         │        └ crc-verified rolling swap
      │         │            │         └ TrainingHealthMonitor verdict
      │         │            └ fleet pump + SLO signal feed
      │         └ LocalOptimizer.train_more
      └ streaming window into the live dataset (dead-man fed)

The invariant the whole loop exists to hold: **a bad parameter set is
never served**.  Every path a bad candidate could take is covered by a
distinct guard, and each guard is exercised by chaos in
``tests/test_continuous_loop.py``:

* a *diverging* model is caught **before** deploy by the training
  health gate (``training/loss_divergence`` firing → outcome
  ``gated``, no replica touched);
* a *poisoned* candidate (corrupt artifact between gate and roll) is
  caught **during** deploy by the per-replica canary
  (:class:`~bigdl_tpu_torch.serving.swap.SwapRejected` → fleet-internal
  rollback of already-swapped replicas → outcome ``rejected``);
* a regression that only shows **under live traffic** is caught after
  deploy by the serving burn-rate watch (``loop/serving_burn`` firing
  inside the watch window → :meth:`ServingFleet.rollback_last_deploy`
  → outcome ``rolled_back``);
* a *stalled pipeline* is caught by the ingest dead-man rule
  (``loop/ingest_deadman``: the batch counter going silent fires a
  page — silence is never mistaken for health);
* and a belt-and-braces audit of every ready replica's installed
  params each interval counts ``bad_params_served`` — the number that
  must stay zero.

Deploys run a small state machine — candidate → gated | canary →
rolled → confirmed | rolled_back (refused when another deploy holds
the fleet lock) — with a cooldown after any failed outcome so a bad
training run cannot machine-gun the fleet.  Terminal outcomes land in
``bigdl_loop_deploys_total{outcome}`` and in :attr:`events`.
"""
from __future__ import annotations

import logging
import time
from collections import Counter as _Counter
from typing import Callable, Iterable, List, Optional, Sequence

import numpy as np

from ..dataset.dataset import TransformedDataSet
from ..dataset.sample import Sample
from ..resilience import faults as _faults
from ..resilience.guards import tree_finite
from ..serving.fleet import FleetQuorumError
from ..serving.status import Status
from ..serving.swap import DeployInFlight, SwapRejected
from ..telemetry import metric_names as M
from ..telemetry.events import record_change as _record_change
from ..telemetry.slo import SloEngine, default_loop_rules
from ..telemetry.timeseries import MetricRecorder
from ..utils.tree import tree_map

log = logging.getLogger(__name__)

#: Terminal deploy-state-machine outcomes
#: (``bigdl_loop_deploys_total{outcome}``).
DEPLOY_OUTCOMES = ("confirmed", "gated", "rejected", "rolled_back",
                   "refused")

#: Request statuses the loop counts against the serving error budget.
#: ``overloaded`` (shed) and ``cancelled`` are deliberate back-pressure
#: — counting them would roll back a healthy deploy under a killed
#: replica or load spike.
_BAD_STATUSES = (Status.INTERNAL_ERROR.value, Status.UNAVAILABLE.value,
                 Status.DEADLINE_EXCEEDED.value)


class ContinuousLoop:
    """Drive online training and health-gated serving as one loop.

    Parameters
    ----------
    optimizer : a prepared :class:`~bigdl_tpu_torch.optim.Optimizer` (its
        model is the serving model; attach a
        :class:`~bigdl_tpu_torch.telemetry.TrainingHealthMonitor` for the
        deploy gate to have teeth — without one every candidate gates
        open).
    fleet : the live :class:`~bigdl_tpu_torch.serving.ServingFleet`.
    ingest : zero-arg callable returning an iterable of fresh
        :class:`~bigdl_tpu_torch.dataset.Sample` (empty/None = nothing new
        this interval — the dead-man notices sustained silence).
    steps_per_interval : optimizer steps per :meth:`tick`.
    deploy_every : attempt a deploy every N intervals (0 disables).
    watch_intervals : post-swap burn-rate watch length, in intervals.
    cooldown_intervals : intervals to back off after a failed deploy
        (gated deploys retry immediately — training may recover by the
        next boundary; rejected/rolled-back ones cool down).
    dataset_capacity : bound on the streaming window (samples); older
        samples evict first.  None = unbounded.
    rules : SLO rule pack for the loop engine (default
        :func:`~bigdl_tpu_torch.telemetry.default_loop_rules`).
    rollback_on : rule names that, firing during the watch window,
        trigger fleet-wide rollback.
    interval_s : nominal tick cadence, used to scale the default rule
        windows (the loop never sleeps — callers own pacing).
    registry : metrics registry for the deploy counter (default: the
        fleet router's, so loop counters fold into the fleet
        snapshot).
    clock : injectable time source (default: the fleet's).
    """

    def __init__(self, optimizer, fleet,
                 ingest: Callable[[], Optional[Iterable[Sample]]], *,
                 steps_per_interval: int = 4,
                 deploy_every: int = 4,
                 watch_intervals: int = 3,
                 cooldown_intervals: int = 4,
                 dataset_capacity: Optional[int] = None,
                 rules: Optional[Sequence] = None,
                 rollback_on: Sequence[str] = ("loop/serving_burn",),
                 interval_s: float = 1.0,
                 registry=None,
                 clock: Optional[Callable[[], float]] = None,
                 max_events: int = 1024):
        if steps_per_interval < 1:
            raise ValueError("steps_per_interval must be >= 1")
        self.optimizer = optimizer
        self.fleet = fleet
        self.ingest = ingest
        self.steps_per_interval = int(steps_per_interval)
        self.deploy_every = int(deploy_every)
        self.watch_intervals = int(watch_intervals)
        self.cooldown_intervals = int(cooldown_intervals)
        self.dataset_capacity = dataset_capacity
        self.rollback_on = tuple(rollback_on)
        self.clock = clock or fleet._clock or time.monotonic
        self._base_dataset = self._resolve_base_dataset(
            optimizer.dataset)

        registry = registry if registry is not None \
            else fleet.router.metrics.registry
        self.recorder = MetricRecorder(clock=self.clock)
        self.engine = SloEngine(
            self.recorder,
            rules=(default_loop_rules(interval_s=interval_s)
                   if rules is None else rules),
            registry=registry, clock=self.clock)
        self._deploys_total = registry.counter(
            M.LOOP_DEPLOYS_TOTAL,
            "terminal deploy state-machine outcomes",
            labels=("outcome",))

        self.intervals = 0
        self.ingested_batches = 0
        self.ingested_samples = 0
        self.deploy_outcomes = _Counter()
        self.bad_params_served = 0
        self.last_loss: Optional[float] = None
        self.losses: List[float] = []
        self.last_rollback_latency_s: Optional[float] = None
        self.last_deployed_params = None
        self._watch_left = 0
        self._cooldown_left = 0
        self._goodput_base = None
        self.events: List[dict] = []
        self._max_events = int(max_events)

    # ------------------------------------------------------------ wiring
    @staticmethod
    def _resolve_base_dataset(dataset):
        """Unwrap transformer layers to the mutable in-memory base the
        streaming window appends into."""
        base = dataset
        while isinstance(base, TransformedDataSet):
            base = base.base
        if not (hasattr(base, "_data") and hasattr(base, "_index")):
            raise TypeError(
                "continuous loop needs an in-memory base dataset "
                "(LocalArrayDataSet-like, with _data/_index) to "
                f"stream into; got {type(base).__name__}")
        return base

    @property
    def state(self) -> str:
        """``watch`` | ``cooldown`` | ``idle``."""
        if self._watch_left > 0:
            return "watch"
        if self._cooldown_left > 0:
            return "cooldown"
        return "idle"

    def _event(self, kind: str, **detail):
        ev = {"at": self.clock(), "interval": self.intervals,
              "kind": kind}
        ev.update(detail)
        self.events.append(ev)
        if len(self.events) > self._max_events:
            del self.events[:len(self.events) - self._max_events]
        log.info("loop[%d]: %s %s", self.intervals, kind, detail)
        return ev

    #: loop deploy-outcome -> change-journal kind (gated/refused never
    #: reach the fleet, so the journal hears about them only here)
    _OUTCOME_EVENTS = {"confirmed": "deploy_confirmed",
                       "rolled_back": "deploy_rolled_back",
                       "gated": "deploy_rejected",
                       "rejected": "deploy_rejected",
                       "refused": "deploy_rejected"}

    def _finish_deploy(self, outcome: str, **detail):
        assert outcome in DEPLOY_OUTCOMES
        self.deploy_outcomes[outcome] += 1
        self._deploys_total.labels(outcome=outcome).inc()
        _record_change(self._OUTCOME_EVENTS[outcome],
                       f"loop outcome={outcome}",
                       source="loop.continuous")
        self._event("deploy", state=outcome, **detail)

    # ------------------------------------------------------------ phases
    def _ingest_once(self):
        fresh = self.ingest()
        fresh = list(fresh) if fresh is not None else []
        if not fresh:
            return
        fault = _faults.check_loop_fault("diverge")
        if fault is not None:
            scale = float(fault.get("scale", 3.0))
            fresh = [Sample(np.asarray(s.feature,
                                       dtype=np.float32) * scale,
                            s.label) for s in fresh]
            self._event("chaos", fault="loss_divergence", scale=scale,
                        samples=len(fresh))
        base = self._base_dataset
        base._data.extend(fresh)
        cap = self.dataset_capacity
        if cap is not None and len(base._data) > cap:
            # evict oldest first: the streaming window is how poisoned
            # ingest washes out and the divergence alert can resolve
            del base._data[:len(base._data) - int(cap)]
        base._index = np.arange(len(base._data))
        self.ingested_batches += 1
        self.ingested_samples += len(fresh)
        # cumulative counter feed — the dead-man rule pages when this
        # series goes silent, so it is fed ONLY on real arrivals
        self.recorder.observe(M.LOOP_INGEST_BATCHES_TOTAL,
                              float(self.ingested_batches),
                              kind="counter")

    def _train_slice(self):
        self.optimizer.train_more(self.steps_per_interval)
        loss = self.optimizer.optim_method.state.get("loss")
        if loss is not None and np.isfinite(float(loss)):
            self.last_loss = float(loss)
            self.losses.append(self.last_loss)
        if self._goodput_base is None:
            # steady-state goodput baseline: taken AFTER the first
            # slice so one-time warmup (kernel builds) is warmup, not waste
            self._goodput_base = self._ledger_seconds()

    def _feed_serving_signals(self):
        total = bad = 0.0
        for srv in self.fleet.servers.values():
            counts = srv.metrics.counts
            total += float(sum(counts.values()))
            bad += float(sum(counts.get(s, 0) for s in _BAD_STATUSES))
        self.recorder.observe(M.LOOP_SERVED_REQUESTS_TOTAL, total,
                              kind="counter")
        self.recorder.observe(M.LOOP_SERVED_BAD_TOTAL, bad,
                              kind="counter")

    def _advance_deploys(self):
        if self._watch_left > 0:
            self._watch_left -= 1
            firing = [a["rule"] for a in self.engine.firing()
                      if a["rule"] in self.rollback_on]
            if firing:
                t0 = time.monotonic()
                try:
                    n = self.fleet.rollback_last_deploy()
                except DeployInFlight:
                    # someone else holds the fleet — stay armed and
                    # retry next interval rather than dropping the
                    # alert on the floor
                    self._watch_left += 1
                    self._event("rollback_deferred", rules=firing)
                    return
                self.last_rollback_latency_s = time.monotonic() - t0
                self._watch_left = 0
                self._cooldown_left = self.cooldown_intervals
                self._finish_deploy(
                    "rolled_back", rules=firing, replicas=n,
                    latency_s=self.last_rollback_latency_s)
            elif self._watch_left == 0:
                self._finish_deploy("confirmed")
            return
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            return
        if self.deploy_every > 0 \
                and self.intervals % self.deploy_every == 0:
            self._attempt_deploy()

    def _attempt_deploy(self):
        self._event("deploy", state="candidate")
        # the gate: only an `ok` training verdict may roll.  No
        # cooldown on gated — the monitor's hysteresis already rate
        # limits, and training may have recovered by the next boundary.
        verdict = self.optimizer.health_verdict()
        if verdict is not None and not verdict.healthy:
            self._finish_deploy("gated", verdict=verdict.status,
                                rules=list(verdict.firing))
            return
        # a snapshot, not the live parameters: training goes on writing
        # those in place after the deploy
        candidate = tree_map(lambda t: t.detach().clone(),
                             self.optimizer.model.param_tree())
        fault = _faults.check_loop_fault("poison_candidate")
        if fault is not None:
            # artifact corruption AFTER the gate — exactly what the
            # per-replica canary exists to catch
            candidate = _faults.poison_params(candidate)
            self._event("chaos", fault="poison_candidate")
        self._event("deploy", state="canary")
        try:
            n = self.fleet.rolling_swap(params=candidate)
        except (SwapRejected, FleetQuorumError) as e:
            self._cooldown_left = self.cooldown_intervals
            self._finish_deploy("rejected", error=str(e))
            return
        except DeployInFlight as e:
            self._finish_deploy("refused", error=str(e))
            return
        self._event("deploy", state="rolled", replicas=n)
        self.last_deployed_params = candidate
        self._watch_left = self.watch_intervals

    def _audit_served_params(self):
        for rid, srv in self.fleet.servers.items():
            if not srv.ready():
                continue
            params, _ = srv.current_params()
            if params is not None and not bool(tree_finite(params)):
                self.bad_params_served += 1
                self._event("bad_params_served", replica=rid)

    # ------------------------------------------------------------ driving
    def tick(self) -> List:
        """One loop interval.  Returns the alert transitions emitted
        this round.  Never sleeps — callers own the cadence (tests
        drive an injected clock)."""
        self.intervals += 1
        self._ingest_once()
        self._train_slice()
        self.fleet.pump_once()
        self._feed_serving_signals()
        alerts = self.engine.evaluate()
        for a in alerts:
            self._event("alert", rule=a.rule, state=a.state,
                        severity=a.severity)
        self._advance_deploys()
        self._audit_served_params()
        return alerts

    def run(self, n_intervals: int,
            on_interval: Optional[Callable[["ContinuousLoop"], None]]
            = None) -> dict:
        """Drive ``n_intervals`` ticks (``on_interval(self)`` after
        each — the traffic/clock hook) and return :meth:`snapshot`."""
        for _ in range(int(n_intervals)):
            self.tick()
            if on_interval is not None:
                on_interval(self)
        return self.snapshot()

    # ------------------------------------------------------------ reporting
    def _ledger_seconds(self):
        tm = self.optimizer.telemetry
        if tm is None:
            return None
        snap = tm.ledger.snapshot()
        secs = snap["seconds"]
        productive = secs.get("productive", 0.0)
        attributed = sum(v for k, v in secs.items() if k != "idle")
        return (productive, attributed)

    def goodput(self) -> Optional[float]:
        """Steady-state training goodput: productive fraction of the
        *attributed* (non-idle) seconds since the post-warmup baseline.
        Idle is excluded because in a serving loop the wall clock
        between slices belongs to serving, not training waste; the
        first slice's kernel builds are warmup (inside the baseline)."""
        if self._goodput_base is None:
            return None
        cur = self._ledger_seconds()
        if cur is None:
            return None
        dp = cur[0] - self._goodput_base[0]
        da = cur[1] - self._goodput_base[1]
        return (dp / da) if da > 0 else None

    def snapshot(self) -> dict:
        return {
            "intervals": self.intervals,
            "state": self.state,
            "watch_left": self._watch_left,
            "cooldown_left": self._cooldown_left,
            "ingested_batches": self.ingested_batches,
            "ingested_samples": self.ingested_samples,
            "deploys": dict(self.deploy_outcomes),
            "bad_params_served": self.bad_params_served,
            "last_loss": self.last_loss,
            "goodput": self.goodput(),
            "last_rollback_latency_s": self.last_rollback_latency_s,
            "alerts": self.engine.snapshot(),
            "events": self.events[-64:],
        }
