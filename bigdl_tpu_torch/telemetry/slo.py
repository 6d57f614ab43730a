"""Online SLO engine: declarative rules over recorder windows,
multi-window burn-rate alerting, anomaly rules, structured alerts.

The observability spine records everything but — before this module —
evaluated nothing online: regressions were caught offline at bench
time (the JAX bench's sentinel) and the control loops acted on
hand-coded raw thresholds.  The :class:`SloEngine` is the online twin
of the offline sentinel: it evaluates a declarative rule set over the
windows a :class:`~.timeseries.MetricRecorder` holds and emits
structured firing/resolved :class:`Alert` events the control planes
act on — the autoscaler consumes verdicts as its breach signal, the
fleet router marks replicas degraded, and the training driver exposes
a :class:`HealthVerdict` the continuous-learning watchdog consults.

Rule kinds
----------
* ``threshold`` — a windowed reducer (:data:`~.timeseries.REDUCERS`)
  compared against a bound.  ``reduce="slope"`` writes loss-descent
  stall rules, ``frac_of_max`` MFU-collapse rules — the reducer
  vocabulary IS the rule vocabulary.
* ``burn_rate`` — the SRE multi-window error-budget form: the bad/
  total event ratio, normalized by the budget, must exceed
  ``burn_factor`` in BOTH a fast and a slow window to fire.  The fast
  window gives detection latency, the slow window immunity to blips;
  recovery clears the fast window first, so resolution is prompt too.
* ``anomaly`` — the recorder's robust ``mad_score`` (newest value vs
  the window median, in MAD units) against a score bound, directional.
  Step-time drift is this rule.
* ``absent`` — the dead-man switch: fires when a series that HAS
  reported stops reporting for a window (a killed replica's health
  feed).  The inverse of the staleness gate.

Every rule carries a **staleness gate**: when its series has not been
fed within ``staleness_s``, the engine renders *no verdict* — state
freezes, nothing fires, nothing resolves (the autoscaler's "no fresh
traffic" gate, generalized).  Firing and resolution both require
``for_intervals`` / ``resolve_intervals`` consecutive evaluations —
one noisy sample alerts nothing.

Alert transitions export as
``bigdl_alerts_total{rule,severity,state}`` plus the
``bigdl_alerts_active`` gauge; :meth:`SloEngine.active_alerts` is the
live snapshot and :meth:`SloEngine.verdict` the one-word summary.
"""
from __future__ import annotations

import logging
import math
import threading
import time
from dataclasses import dataclass, field as dc_field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import metric_names as M
from .timeseries import MetricRecorder

log = logging.getLogger("bigdl_tpu")

__all__ = [
    "Alert", "HealthVerdict", "SloEngine", "SloRule",
    "TrainingHealthMonitor", "default_loop_rules",
    "default_serving_rules", "default_training_rules",
    "ingest_deadman_rule",
]

_OPS = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}


@dataclass
class SloRule:
    """One declarative health rule — see the module docstring for the
    kinds.  ``family``/``labels``/``signal`` address the recorder
    series (``signal`` is the sampled field: ``value`` for counters/
    gauges, ``count``/``sum``/``p99``… for histograms); reference
    families through :mod:`~bigdl_tpu_torch.telemetry.metric_names` so a
    rename can never orphan the rule."""
    name: str
    family: str = ""
    labels: Dict[str, str] = dc_field(default_factory=dict)
    signal: str = "value"
    kind: str = "threshold"        # threshold | burn_rate | anomaly | absent
    severity: str = "page"         # page | ticket
    description: str = ""
    # -- shared evaluation knobs
    window_s: float = 60.0
    staleness_s: Optional[float] = None   # default: window_s
    for_intervals: int = 1
    resolve_intervals: int = 1
    min_samples: int = 1
    # -- threshold
    reduce: str = "last"
    op: str = ">="
    threshold: float = 0.0
    # -- burn_rate (bad series = family/labels/signal above)
    total_family: str = ""
    total_labels: Dict[str, str] = dc_field(default_factory=dict)
    total_signal: str = "value"
    budget: float = 0.01           # allowed bad fraction of total
    fast_window_s: float = 60.0
    slow_window_s: float = 600.0
    burn_factor: float = 2.0
    # -- anomaly
    score: float = 4.0
    direction: str = "up"          # up | down | both

    def __post_init__(self):
        if self.kind not in ("threshold", "burn_rate", "anomaly",
                             "absent"):
            raise ValueError(f"rule {self.name!r}: unknown kind "
                             f"{self.kind!r}")
        if self.kind == "threshold" and self.op not in _OPS:
            raise ValueError(f"rule {self.name!r}: unknown op "
                             f"{self.op!r}")
        if self.kind == "burn_rate" and not self.total_family:
            raise ValueError(f"rule {self.name!r}: burn_rate needs "
                             f"total_family")
        if self.severity not in ("page", "ticket"):
            raise ValueError(f"rule {self.name!r}: severity must be "
                             f"page|ticket")

    @property
    def stale_after(self) -> float:
        if self.staleness_s is not None:
            return float(self.staleness_s)
        if self.kind == "burn_rate":
            return float(self.fast_window_s)
        return float(self.window_s)


@dataclass
class Alert:
    """One structured firing/resolved transition."""
    rule: str
    severity: str
    state: str                     # firing | resolved
    at: float
    value: Optional[float] = None
    reason: str = ""
    labels: Dict[str, str] = dc_field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"rule": self.rule, "severity": self.severity,
                "state": self.state, "at": self.at,
                "value": self.value, "reason": self.reason,
                "labels": dict(self.labels)}


@dataclass(frozen=True)
class HealthVerdict:
    """The one-word health summary a watchdog consults: ``ok`` (no
    firing alerts), ``degraded`` (ticket-severity firing), or
    ``critical`` (page-severity firing)."""
    status: str
    firing: Tuple[str, ...]
    at: float

    @property
    def healthy(self) -> bool:
        return self.status == "ok"


class _RuleState:
    __slots__ = ("breach_streak", "clear_streak", "firing", "fired_at",
                 "last_value", "last_verdict_at")

    def __init__(self):
        self.breach_streak = 0
        self.clear_streak = 0
        self.firing = False
        self.fired_at: Optional[float] = None
        self.last_value: Optional[float] = None
        self.last_verdict_at: Optional[float] = None


class SloEngine:
    """Evaluates a rule set over one recorder — see the module
    docstring.  Thread-safe; ``evaluate()`` is the cadence tick."""

    def __init__(self, recorder: MetricRecorder,
                 rules: Sequence[SloRule] = (),
                 registry=None,
                 clock: Optional[Callable[[], float]] = None,
                 max_events: int = 1024):
        self.recorder = recorder
        self.clock = clock or recorder.clock
        self._lock = threading.RLock()
        self._rules: Dict[str, SloRule] = {}
        self._state: Dict[str, _RuleState] = {}
        self.events: List[Alert] = []
        self._max_events = int(max_events)
        self.evaluations = 0
        if registry is None:
            from .registry import default_registry

            registry = default_registry()
        self.registry = registry
        self._alerts_total = registry.counter(
            M.ALERTS_TOTAL,
            "SLO alert transitions per rule, severity and state",
            labels=("rule", "severity", "state"))
        self._alerts_active = registry.gauge(
            M.ALERTS_ACTIVE, "alerts currently firing in this engine")
        for rule in rules:
            self.add_rule(rule)

    # ------------------------------------------------------------ rules
    def add_rule(self, rule: SloRule) -> SloRule:
        with self._lock:
            if rule.name in self._rules:
                raise ValueError(f"rule {rule.name!r} already "
                                 f"registered")
            self._rules[rule.name] = rule
            self._state[rule.name] = _RuleState()
        return rule

    def remove_rule(self, name: str):
        with self._lock:
            self._rules.pop(name, None)
            st = self._state.pop(name, None)
        if st is not None and st.firing:
            self._alerts_active.dec()

    @property
    def rules(self) -> Tuple[SloRule, ...]:
        with self._lock:
            return tuple(self._rules.values())

    # ------------------------------------------------------------ predicates
    def _eval_threshold(self, rule: SloRule, now: float):
        v = self.recorder.reduce(
            rule.family, rule.reduce, labels=rule.labels,
            field=rule.signal, window_s=rule.window_s, now=now,
            min_samples=rule.min_samples)
        if v is None:
            return None, None
        return _OPS[rule.op](v, rule.threshold), v

    def _eval_burn_rate(self, rule: SloRule, now: float):
        burns = []
        for win in (rule.fast_window_s, rule.slow_window_s):
            bad = self.recorder.reduce(
                rule.family, "rate", labels=rule.labels,
                field=rule.signal, window_s=win, now=now,
                min_samples=2)
            total = self.recorder.reduce(
                rule.total_family, "rate", labels=rule.total_labels,
                field=rule.total_signal, window_s=win, now=now,
                min_samples=2)
            if bad is None or total is None:
                return None, None
            ratio = (bad / total) if total > 0 else 0.0
            burns.append(ratio / max(rule.budget, 1e-12))
        # firing needs BOTH windows burning; the recorded value is the
        # fast burn (the number that moves first, both ways)
        return (burns[0] >= rule.burn_factor
                and burns[1] >= rule.burn_factor), burns[0]

    def _eval_anomaly(self, rule: SloRule, now: float):
        v = self.recorder.reduce(
            rule.family, "mad_score", labels=rule.labels,
            field=rule.signal, window_s=rule.window_s, now=now,
            min_samples=max(3, rule.min_samples))
        if v is None:
            return None, None
        if rule.direction == "up":
            breach = v >= rule.score
        elif rule.direction == "down":
            breach = v <= -rule.score
        else:
            breach = abs(v) >= rule.score
        return breach, (None if math.isinf(v)
                        else v)

    def _eval_absent(self, rule: SloRule, now: float):
        age = self.recorder.age(rule.family, labels=rule.labels,
                                field=rule.signal, now=now)
        if age is None:
            # never reported: nothing to go dead — no verdict (a
            # fleet booting up must not page for replicas that have
            # not published yet)
            return None, None
        return age > rule.window_s, age

    # ------------------------------------------------------------ evaluate
    def evaluate(self, now: Optional[float] = None) -> List[Alert]:
        """One evaluation round over every rule.  Returns the alert
        transitions emitted THIS round (most rounds: none)."""
        now = self.clock() if now is None else now
        emitted: List[Alert] = []
        with self._lock:
            rules = list(self._rules.values())
        for rule in rules:
            # staleness gate: an unfed series renders NO verdict —
            # the absent kind is the one rule ABOUT staleness
            if rule.kind != "absent":
                age = self.recorder.age(rule.family,
                                        labels=rule.labels,
                                        field=rule.signal, now=now)
                if age is None or age > rule.stale_after:
                    continue
            if rule.kind == "threshold":
                breach, value = self._eval_threshold(rule, now)
            elif rule.kind == "burn_rate":
                breach, value = self._eval_burn_rate(rule, now)
            elif rule.kind == "anomaly":
                breach, value = self._eval_anomaly(rule, now)
            else:
                breach, value = self._eval_absent(rule, now)
            if breach is None:
                continue
            st = self._state[rule.name]
            st.last_value = value
            st.last_verdict_at = now
            if breach:
                st.breach_streak += 1
                st.clear_streak = 0
                if not st.firing \
                        and st.breach_streak >= rule.for_intervals:
                    st.firing = True
                    st.fired_at = now
                    emitted.append(self._emit(rule, "firing", now,
                                              value))
            else:
                st.clear_streak += 1
                st.breach_streak = 0
                if st.firing \
                        and st.clear_streak >= rule.resolve_intervals:
                    st.firing = False
                    st.fired_at = None
                    emitted.append(self._emit(rule, "resolved", now,
                                              value))
        with self._lock:
            self.evaluations += 1
            self._alerts_active.set(float(sum(
                1 for s in self._state.values() if s.firing)))
        return emitted

    def _emit(self, rule: SloRule, state: str, now: float,
              value) -> Alert:
        reason = (f"{rule.description or rule.kind}"
                  f" (value={value!r})" if state == "firing"
                  else f"recovered (value={value!r})")
        alert = Alert(rule=rule.name, severity=rule.severity,
                      state=state, at=now, value=value, reason=reason,
                      labels=dict(rule.labels))
        with self._lock:
            self.events.append(alert)
            if len(self.events) > self._max_events:
                del self.events[:len(self.events) - self._max_events]
        self._alerts_total.labels(rule=rule.name,
                                  severity=rule.severity,
                                  state=state).inc()
        (log.warning if state == "firing" else log.info)(
            "slo: %s %s [%s] %s", state.upper(), rule.name,
            rule.severity, reason)
        return alert

    # ------------------------------------------------------------ reading
    def firing(self, names: Optional[Sequence[str]] = None
               ) -> List[dict]:
        """Currently firing alerts (optionally restricted to a rule
        subset), as dicts carrying the rule, severity, value, and
        fired-at time."""
        out = []
        with self._lock:
            for name, st in self._state.items():
                if not st.firing:
                    continue
                if names is not None and name not in names:
                    continue
                rule = self._rules[name]
                out.append({"rule": name, "severity": rule.severity,
                            "labels": dict(rule.labels),
                            "value": st.last_value,
                            "since": st.fired_at,
                            "last_verdict_at": st.last_verdict_at,
                            "description": rule.description})
        return sorted(out, key=lambda a: a["rule"])

    def active_alerts(self) -> List[dict]:
        return self.firing()

    def verdict(self, now: Optional[float] = None) -> HealthVerdict:
        now = self.clock() if now is None else now
        firing = self.firing()
        if not firing:
            return HealthVerdict("ok", (), now)
        status = ("critical" if any(a["severity"] == "page"
                                    for a in firing) else "degraded")
        return HealthVerdict(status,
                             tuple(a["rule"] for a in firing), now)

    def snapshot(self) -> dict:
        """The publishable view: active alerts, recent transitions,
        per-rule state — what ``Telemetry.payload`` ships and the run
        report renders with ``alerts=True``."""
        with self._lock:
            events = [a.to_dict() for a in self.events[-64:]]
            rules = {
                name: {"firing": st.firing, "since": st.fired_at,
                       "value": st.last_value,
                       "breach_streak": st.breach_streak,
                       "severity": self._rules[name].severity}
                for name, st in sorted(self._state.items())}
            evaluations = self.evaluations
        return {"active": self.active_alerts(), "recent": events,
                "rules": rules, "evaluations": evaluations,
                "verdict": self.verdict().status}


# ---------------------------------------------------------------------------
# default rule packs
# ---------------------------------------------------------------------------

def default_serving_rules(pool: str = "both", *,
                          tenant: Optional[str] = None,
                          p99_high_s: float = 0.5,
                          shed_high: float = 0.02,
                          kv_occupancy_high: float = 0.90,
                          error_budget: float = 0.02,
                          window_s: float = 30.0,
                          fast_window_s: float = 30.0,
                          slow_window_s: float = 300.0,
                          burn_factor: float = 2.0,
                          for_intervals: int = 2,
                          resolve_intervals: int = 2
                          ) -> List[SloRule]:
    """The serving rule pack for ONE role pool, over the per-pool
    signals the autoscaler feeds its recorder: p99, shed rate, KV
    occupancy thresholds plus the multi-window shed error-budget
    burn.

    ``tenant`` instantiates the pack per tenant on a multi-tenant
    fleet: the rules watch that tenant's ``model:role`` pool series
    (the spec :func:`~bigdl_tpu_torch.serving.pools.split_pool` parses, the
    series a tenant-scoped autoscaler pool feeds) under distinct rule
    names — each tenant's pack fires and resolves independently, so
    one tenant burning its budget never marks another tenant's
    traffic degraded."""
    pool = pool if tenant is None else f"{tenant}:{pool}"
    L = {"pool": pool}
    return [
        SloRule(name=f"serving/{pool}/p99",
                family=M.AUTOSCALE_POOL_P99_SECONDS, labels=L,
                kind="threshold", reduce="last", op=">=",
                threshold=p99_high_s, window_s=window_s,
                for_intervals=for_intervals,
                resolve_intervals=resolve_intervals,
                description=f"{pool} pool p99 >= {p99_high_s}s"),
        SloRule(name=f"serving/{pool}/shed_rate",
                family=M.AUTOSCALE_POOL_SHED_RATE, labels=L,
                kind="threshold", reduce="last", op=">=",
                threshold=shed_high, window_s=window_s,
                for_intervals=for_intervals,
                resolve_intervals=resolve_intervals,
                description=f"{pool} pool shedding >= "
                            f"{100 * shed_high:g}% of fresh traffic"),
        SloRule(name=f"serving/{pool}/kv_occupancy",
                family=M.AUTOSCALE_POOL_KV_OCCUPANCY, labels=L,
                kind="threshold", reduce="last", op=">=",
                threshold=kv_occupancy_high, window_s=window_s,
                for_intervals=for_intervals,
                resolve_intervals=resolve_intervals, severity="ticket",
                description=f"{pool} pool KV occupancy >= "
                            f"{kv_occupancy_high:g}"),
        SloRule(name=f"serving/{pool}/error_budget",
                family=M.AUTOSCALE_POOL_SHED_TOTAL, labels=L,
                total_family=M.AUTOSCALE_POOL_REQUESTS_TOTAL,
                total_labels=L, kind="burn_rate", budget=error_budget,
                fast_window_s=fast_window_s,
                slow_window_s=slow_window_s, burn_factor=burn_factor,
                for_intervals=for_intervals,
                resolve_intervals=resolve_intervals,
                description=f"{pool} pool burning its "
                            f"{100 * error_budget:g}% error budget at "
                            f">= {burn_factor:g}x in both windows"),
    ]


def default_training_rules(*, goodput_floor: float = 0.5,
                           step_drift_score: float = 6.0,
                           loss_window_s: float = 120.0,
                           loss_min_slope: float = 0.0,
                           divergence_ratio: float = 1.5,
                           mfu_drop_frac: float = 0.5,
                           window_s: float = 60.0,
                           for_intervals: int = 2,
                           resolve_intervals: int = 2
                           ) -> List[SloRule]:
    """The training rule pack: goodput productive-fraction floor,
    step-time drift (MAD anomaly), loss-descent stall + divergence,
    and MFU collapse — the online verdicts the continuous-learning
    watchdog consults."""
    return [
        SloRule(name="training/goodput",
                family=M.GOODPUT_PRODUCTIVE_FRACTION,
                kind="threshold", reduce="last", op="<",
                threshold=goodput_floor, window_s=window_s,
                for_intervals=for_intervals,
                resolve_intervals=resolve_intervals, severity="ticket",
                description=f"goodput productive fraction < "
                            f"{goodput_floor:g}"),
        SloRule(name="training/step_time_drift",
                family=M.TRAIN_STEP_TIME_SECONDS, kind="anomaly",
                score=step_drift_score, direction="up",
                window_s=window_s, for_intervals=for_intervals,
                resolve_intervals=resolve_intervals, severity="ticket",
                min_samples=8,
                description=f"step time drifted >= "
                            f"{step_drift_score:g} MADs above the "
                            f"window median"),
        SloRule(name="training/loss_stall",
                family=M.TRAIN_LOSS, kind="threshold", reduce="slope",
                op=">=", threshold=-abs(loss_min_slope),
                window_s=loss_window_s, for_intervals=for_intervals,
                resolve_intervals=resolve_intervals, severity="ticket",
                min_samples=8,
                description="loss stopped descending (robust slope "
                            "over the window)"),
        SloRule(name="training/loss_divergence",
                family=M.TRAIN_LOSS, kind="threshold",
                reduce="frac_of_min", op=">=",
                threshold=divergence_ratio, window_s=loss_window_s,
                for_intervals=for_intervals,
                resolve_intervals=resolve_intervals,
                min_samples=4,
                description=f"loss >= {divergence_ratio:g}x its "
                            f"window minimum (divergence)"),
        SloRule(name="training/mfu_collapse",
                family=M.PERF_MFU, kind="threshold",
                reduce="frac_of_max", op="<", threshold=mfu_drop_frac,
                window_s=window_s, for_intervals=for_intervals,
                resolve_intervals=resolve_intervals,
                min_samples=4,
                description=f"MFU fell below {mfu_drop_frac:g}x its "
                            f"window maximum"),
    ]


def ingest_deadman_rule(*, window_s: float = 5.0,
                        name: str = "loop/ingest_deadman",
                        severity: str = "page") -> SloRule:
    """The streaming-ingest dead-man switch: the continuous-learning
    loop feeds its cumulative fresh-batch counter every interval that
    delivers data; a stream that HAS delivered and then goes silent
    for more than ``window_s`` fires this structured alert instead of
    silently idling the trainer.  (A loop that has never ingested
    renders no verdict — booting up is not a stall.)"""
    return SloRule(
        name=name, family=M.LOOP_INGEST_BATCHES_TOTAL, kind="absent",
        window_s=window_s, severity=severity,
        description=f"ingest stream silent > {window_s:g}s (dead-man)")


def default_loop_rules(*, interval_s: float = 1.0,
                       deadman_intervals: int = 5,
                       serve_budget: float = 0.05,
                       burn_factor: float = 2.0,
                       fast_intervals: int = 4,
                       slow_intervals: int = 16,
                       for_intervals: int = 2,
                       resolve_intervals: int = 2) -> List[SloRule]:
    """The continuous-learning loop's rule pack: the ingest dead-man
    switch plus the **post-swap burn-rate watch** — the SRE
    multi-window error-budget burn over the fleet-wide served bad/
    total counters the loop feeds each interval.  While a fresh deploy
    is inside its watch window, a firing ``loop/serving_burn`` is the
    signal that triggers automatic fleet-wide rollback
    (``ServingFleet.rollback_last_deploy``); outside a watch it is an
    ordinary page.  Windows are sized in loop intervals
    (``interval_s`` scales them to the loop's cadence)."""
    return [
        ingest_deadman_rule(
            window_s=deadman_intervals * interval_s),
        SloRule(name="loop/serving_burn",
                family=M.LOOP_SERVED_BAD_TOTAL,
                total_family=M.LOOP_SERVED_REQUESTS_TOTAL,
                kind="burn_rate", budget=serve_budget,
                fast_window_s=fast_intervals * interval_s,
                slow_window_s=slow_intervals * interval_s,
                burn_factor=burn_factor,
                for_intervals=for_intervals,
                resolve_intervals=resolve_intervals,
                description=f"fleet serving errors burning the "
                            f"{100 * serve_budget:g}% budget at >= "
                            f"{burn_factor:g}x in both windows "
                            f"(post-swap watch)"),
    ]


# ---------------------------------------------------------------------------
# the training-side monitor (the driver hook)
# ---------------------------------------------------------------------------

class TrainingHealthMonitor:
    """The training driver's online watchdog: feeds per-step loss and
    step time (plus goodput/MFU at evaluation cadence) into a
    recorder, evaluates the training rule pack every
    ``every_n_steps``, and answers :meth:`verdict` — the
    :class:`HealthVerdict` hook the continuous-learning scenario
    consults while the run is LIVE.

    Attach with ``optimizer.set_health_monitor(monitor)``; the driver
    calls :meth:`on_step` each iteration.  Built from a
    :class:`~bigdl_tpu_torch.telemetry.Telemetry` bundle it shares the
    bundle's registry (alert counters land in the same snapshot) and
    registers itself as the bundle's ``slo`` engine so
    ``Telemetry.payload()`` publishes the active-alert view.
    """

    def __init__(self, telemetry=None,
                 rules: Optional[Sequence[SloRule]] = None,
                 every_n_steps: int = 8,
                 recorder: Optional[MetricRecorder] = None,
                 registry=None,
                 clock: Callable[[], float] = time.monotonic):
        self.telemetry = telemetry
        self.every_n_steps = max(1, int(every_n_steps))
        self.recorder = recorder or MetricRecorder(clock=clock)
        if registry is None and telemetry is not None:
            registry = telemetry.registry
        self.engine = SloEngine(
            self.recorder,
            rules=(rules if rules is not None
                   else default_training_rules()),
            registry=registry, clock=self.recorder.clock)
        if telemetry is not None and \
                getattr(telemetry, "slo", None) is None:
            telemetry.slo = self.engine
        self._steps = 0

    def on_step(self, step: int, loss: float, seconds: float):
        """One driver iteration: feed the loss/step-time series; at
        cadence, refresh the slow signals and evaluate the rules."""
        r = self.recorder
        if loss == loss and not math.isinf(loss):  # NaN/Inf never
            r.observe(M.TRAIN_LOSS, float(loss))   # poison a window
        r.observe(M.TRAIN_STEP_TIME_SECONDS, float(seconds))
        self._steps += 1
        if self._steps % self.every_n_steps == 0:
            self._refresh_slow_signals()
            self.engine.evaluate()

    def _refresh_slow_signals(self):
        tm = self.telemetry
        if tm is None:
            return
        try:
            snap = tm.ledger.snapshot()
            self.recorder.observe(M.GOODPUT_PRODUCTIVE_FRACTION,
                                  float(snap["productive_fraction"]))
            fam = tm.registry.get(M.PERF_MFU)
            if fam is not None:
                for _labels, child in fam.series():
                    if child.value > 0:
                        self.recorder.observe(M.PERF_MFU,
                                              float(child.value))
                    break
        except Exception:  # health accounting must never stop training
            log.debug("health monitor slow-signal refresh failed",
                      exc_info=True)

    def evaluate(self, now: Optional[float] = None):
        return self.engine.evaluate(now=now)

    def verdict(self, now: Optional[float] = None) -> HealthVerdict:
        return self.engine.verdict(now=now)

    def snapshot(self) -> dict:
        return self.engine.snapshot()
