"""Per-replica SLO health: the fleet-side consumer of the online
health engine (counterpart of ``bigdl_tpu/serving/health.py``).

The router already ejects replicas that go SILENT (missed heartbeats)
or say so themselves (breaker open); what it could not see before
this module is a replica that keeps answering but answers BADLY — a
p99 drifting 10x above its peers, an error rate quietly burning the
budget.  The :class:`FleetHealthMonitor` closes that gap: each pump
round it feeds every replica's published health snapshot into a
:class:`~bigdl_tpu_torch.telemetry.timeseries.MetricRecorder` (per-replica
labeled series), evaluates per-replica SLO rules
(:class:`~bigdl_tpu_torch.telemetry.slo.SloEngine`), and on a firing rule
marks the replica **degraded** on the router —
:meth:`~.router.FleetRouter.mark_degraded`, which feeds the existing
eject machinery (eviction marker + incarnation bump, exactly the
breaker-open path).  When the rule resolves, the mark clears and the
replica re-admits through the normal returner path.

Rules are instantiated per replica from a template
(:class:`ReplicaHealthPolicy`) as replicas join (autoscaler
scale-ups included) and retired with them.  A replica whose health
feed goes DEAD (killed, partitioned) trips the ``absent`` dead-man
rule — alert-visible even before the heartbeat timeout ejects it.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from ..telemetry import metric_names as M
from ..telemetry.slo import SloEngine, SloRule
from ..telemetry.timeseries import MetricRecorder

log = logging.getLogger("bigdl_tpu")

__all__ = ["FleetHealthMonitor", "ReplicaHealthPolicy"]


@dataclass
class ReplicaHealthPolicy:
    """Per-replica degradation thresholds (the rule template)."""
    #: p99 above this for ``for_intervals`` pump rounds ⇒ degraded
    p99_high_s: float = 2.0
    #: non-OK fraction of the replica's fresh traffic burning this
    #: error budget at >= ``burn_factor`` in both windows ⇒ degraded
    error_budget: float = 0.05
    burn_factor: float = 2.0
    fast_window_s: float = 15.0
    slow_window_s: float = 120.0
    #: health feed silent this long (while the series exists) ⇒ the
    #: dead-man alert fires (the router's heartbeat timeout still owns
    #: the eject for true deaths — this is alert visibility)
    feed_dead_s: float = 5.0
    window_s: float = 30.0
    for_intervals: int = 2
    resolve_intervals: int = 2


class FleetHealthMonitor:
    """Feeds published replica health into an SLO engine and acts on
    the verdicts — see the module docstring.

    Parameters
    ----------
    fleet : the :class:`~.fleet.ServingFleet` (pump loop calls
        :meth:`observe` once per round).
    policy : the per-replica rule template.
    registry : where alert counters land (defaults to the router's
        metrics registry, so ``bigdl_alerts_total`` folds into the
        fleet view).
    mark_degraded : whether firing rules actuate the router (False =
        observe-only: alerts fire, routing untouched).
    """

    def __init__(self, fleet, policy: Optional[ReplicaHealthPolicy]
                 = None, registry=None, mark_degraded: bool = True,
                 clock: Optional[Callable[[], float]] = None,
                 incidents: bool = False,
                 incident_policy=None):
        self.fleet = fleet
        self.policy = policy or ReplicaHealthPolicy()
        self.mark_degraded = bool(mark_degraded)
        self._clock = clock or getattr(fleet, "_clock", time.monotonic)
        self.recorder = MetricRecorder(clock=self._clock)
        self.engine = SloEngine(
            self.recorder,
            registry=(registry if registry is not None
                      else fleet.router.metrics.registry),
            clock=self._clock)
        #: optional incident engine (telemetry/incidents.py): built
        #: over this monitor's recorder + engine so a firing replica
        #: rule freezes its black box and ranks the change journal
        self.incidents = None
        if incidents:
            from ..telemetry.incidents import IncidentEngine
            self.incidents = IncidentEngine(
                self.recorder, engine=self.engine,
                policy=incident_policy,
                registry=self.engine.registry, clock=self._clock)
        #: replica -> its rule names (installed lazily on first feed)
        self._replica_rules: Dict[str, List[str]] = {}
        #: replica -> the label set its rules/series were installed
        #: under (includes ``model`` on multi-tenant fleets)
        self._replica_labels: Dict[str, Dict[str, str]] = {}
        #: last-seen health publish stamp per replica — a KV snapshot
        #: that stopped CHANGING is a dead feed, however fresh the
        #: router's last read of it looks
        self._last_ts: Dict[str, float] = {}
        #: marks THIS monitor placed (never clear someone else's)
        self._marked: Dict[str, bool] = {}

    # ------------------------------------------------------------ rules
    def _rules_for(self, rid: str,
                   model: Optional[str] = None) -> List[SloRule]:
        p = self.policy
        # multi-tenant fleets label the replica's rules (and therefore
        # its alerts) with the model it advertises, so a firing rule
        # attributes to ONE tenant — and since a replica serves one
        # model, marking it degraded ejects capacity from that tenant
        # only, never unrouting the other tenants' replicas
        L = {"replica": rid}
        if model is not None:
            L = {"replica": rid, "model": str(model)}
        return [
            SloRule(name=f"replica/{rid}/p99",
                    family=M.REPLICA_P99_SECONDS, labels=L,
                    kind="threshold", reduce="last", op=">=",
                    threshold=p.p99_high_s, window_s=p.window_s,
                    for_intervals=p.for_intervals,
                    resolve_intervals=p.resolve_intervals,
                    description=f"replica {rid} p99 >= "
                                f"{p.p99_high_s}s"),
            SloRule(name=f"replica/{rid}/error_budget",
                    family=M.REPLICA_ERRORS_TOTAL, labels=L,
                    total_family=M.REPLICA_REQUESTS_TOTAL,
                    total_labels=L, kind="burn_rate",
                    budget=p.error_budget,
                    fast_window_s=p.fast_window_s,
                    slow_window_s=p.slow_window_s,
                    burn_factor=p.burn_factor,
                    for_intervals=p.for_intervals,
                    resolve_intervals=p.resolve_intervals,
                    description=f"replica {rid} burning its "
                                f"{100 * p.error_budget:g}% error "
                                f"budget"),
            SloRule(name=f"replica/{rid}/health_feed",
                    family=M.REPLICA_P99_SECONDS, labels=L,
                    kind="absent", window_s=p.feed_dead_s,
                    resolve_intervals=1, severity="ticket",
                    description=f"replica {rid} health feed went "
                                f"silent"),
        ]

    def _ensure_rules(self, rid: str, model: Optional[str] = None):
        if rid in self._replica_rules:
            return
        rules = self._rules_for(rid, model=model)
        for rule in rules:
            self.engine.add_rule(rule)
        self._replica_rules[rid] = [r.name for r in rules]
        self._replica_labels[rid] = dict(rules[0].labels)

    def _retire_rules(self, rid: str):
        for name in self._replica_rules.pop(rid, ()):
            self.engine.remove_rule(name)
        self._replica_labels.pop(rid, None)
        self._last_ts.pop(rid, None)
        if self._marked.pop(rid, None):
            self.fleet.router.clear_degraded(rid)

    # ------------------------------------------------------------ observe
    def observe(self, now: Optional[float] = None) -> List[dict]:
        """One pump round: feed fresh health snapshots, evaluate, and
        actuate the router marks.  Returns this round's alert
        transitions (as dicts)."""
        now = self._clock() if now is None else now
        router = self.fleet.router
        live_rids = set(self.fleet.servers)
        for rid in sorted(self._replica_rules.keys() - live_rids):
            self._retire_rules(rid)    # autoscale retire / removal
        for rid in sorted(live_rids):
            h = router.health_of(rid)
            if not h:
                continue
            ts = float(h.get("ts") or 0.0)
            if self._last_ts.get(rid) == ts:
                continue               # feed stopped: let it go stale
            self._last_ts[rid] = ts
            self._ensure_rules(rid, model=h.get("model"))
            L = self._replica_labels[rid]
            r = self.recorder
            if h.get("p99_s") is not None:
                r.observe(M.REPLICA_P99_SECONDS, float(h["p99_s"]),
                          labels=L, now=now)
            r.observe(M.REPLICA_QUEUE_DEPTH,
                      float(h.get("queue_depth") or 0), labels=L,
                      now=now)
            total = float(h.get("requests_total") or 0)
            errors = max(0.0, total - float(h.get("served_ok") or 0))
            r.observe(M.REPLICA_REQUESTS_TOTAL, total, labels=L,
                      kind="counter", now=now)
            r.observe(M.REPLICA_ERRORS_TOTAL, errors, labels=L,
                      kind="counter", now=now)
        emitted = self.engine.evaluate(now=now)
        self._actuate()
        out = [a.to_dict() for a in emitted]
        if self.incidents is not None:
            # chain the incident engine on this round's transitions:
            # a fresh firing opens + freezes its capture window here
            self.incidents.observe(out, now=now)
        return out

    def _actuate(self):
        if not self.mark_degraded:
            return
        firing_by_rid: Dict[str, List[dict]] = {}
        for alert in self.engine.firing():
            rid = alert["labels"].get("replica")
            if rid is not None:
                firing_by_rid.setdefault(rid, []).append(alert)
        router = self.fleet.router
        for rid in list(self._replica_rules):
            firing = firing_by_rid.get(rid)
            if firing and not self._marked.get(rid):
                reason = "; ".join(a["rule"] for a in firing)
                router.mark_degraded(rid, reason)
                self._marked[rid] = True
            elif not firing and self._marked.get(rid):
                router.clear_degraded(rid)
                self._marked[rid] = False

    # ------------------------------------------------------------ reading
    def degraded(self) -> Dict[str, str]:
        """Replicas this monitor currently holds degraded."""
        return {rid: reason
                for rid, reason in self.fleet.router.degraded.items()
                if self._marked.get(rid)}

    def snapshot(self) -> dict:
        return {"engine": self.engine.snapshot(),
                "degraded": self.degraded(),
                "replicas_watched": sorted(self._replica_rules),
                "incidents": (self.incidents.snapshot()
                              if self.incidents is not None else None)}
