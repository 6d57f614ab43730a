"""Telemetry-driven autoscaling: replica counts that track load
(counterpart of ``bigdl_tpu/serving/autoscale.py``).

A fixed fleet sized for the peak wastes devices off-peak and sheds at
the peak it was mis-sized for.  The :class:`Autoscaler` is a control
loop over the signals the router already aggregates — per-pool p99,
shed rate, published queue depth, and KV-pool occupancy, all read from
the health snapshots replicas publish every heartbeat — scaling each
role pool (``prefill`` / ``decode`` / ``both``) **independently**:
prefill is compute-bound and decode memory-bound (the roofline
split), so their load signals, and therefore their replica counts,
move separately.

Control discipline (what keeps it from flapping):

* **Hysteresis** — a breach (or idle) signal must sustain for
  ``sustain`` (``idle_sustain``) consecutive evaluations before any
  action; one noisy sample scales nothing.
* **Cooldown** — after any action the pool holds for ``cooldown_s``;
  a new replica needs time to warm (its kernels load at first use)
  before its effect is measurable.
* **Bounds** — ``min_replicas``/``max_replicas`` clamp every pool.
* **Drain-before-retire** — scale-down rides the graceful-preemption
  path (:meth:`~.fleet.ServingFleet.remove_replica` with
  ``drain=True``): admission stops, everything admitted finishes
  (paged decodes resolve and release their pages), then the replica
  leaves membership.

Every decision is a structured event (kept in ``decisions``, logged)
plus a ``bigdl_autoscale_decisions_total{pool,direction}`` counter in
the router registry, so the scaling history is scrape-visible next to
the request metrics it acted on.

Since the online health engine (``telemetry/slo.py``) the breach
signal is, by default, an **SLO verdict**: the per-pool signals feed a
:class:`~bigdl_tpu_torch.telemetry.timeseries.MetricRecorder`, each raw
watermark is a declarative rule in a
:class:`~bigdl_tpu_torch.telemetry.slo.SloEngine`, and a breach is a FIRING
alert — same thresholds, same hysteresis/cooldown/bounds semantics
(decision-for-decision identical, tested), but every breach and
recovery is now a structured ``bigdl_alerts_total`` transition an
operator can scrape and page on.  ``signal_source="raw"`` keeps the
pre-SLO inline-comparison path as the fallback.
"""
from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..telemetry.events import record_change as _record_change
from .pools import serves_phase, split_pool

log = logging.getLogger("bigdl_tpu")

__all__ = ["AutoscalePolicy", "Autoscaler"]


@dataclass
class AutoscalePolicy:
    """Per-pool scaling policy — thresholds, hysteresis, bounds."""
    min_replicas: int = 1
    max_replicas: int = 8
    #: scale-up watermarks: breach ANY of these...
    p99_high_s: float = 0.5
    shed_high: float = 0.02        # shed fraction of the eval window
    queue_high: int = 32           # summed published queue depth
    kv_occupancy_high: float = 0.90
    #: ...for this many consecutive evaluations
    sustain: int = 2
    #: scale-down watermarks: ALL of these, sustained idle_sustain
    p99_idle_s: float = 0.050
    queue_idle: int = 1
    kv_occupancy_idle: float = 0.50
    idle_sustain: int = 3
    #: traffic-activity gate: when set, p99/queue breaches only count
    #: while the pool saw MORE than this many requests since the last
    #: evaluation (the published p99 is a windowed quantile — over no
    #: fresh traffic it is stale history, not an actionable signal),
    #: and a quiet pool (≤ this delta) reads as idle regardless of
    #: that stale p99.  None disables the gate (breaches always
    #: actionable; idleness judged by p99_idle_s alone).
    idle_requests_delta: Optional[int] = None
    #: no second action within the cooldown
    cooldown_s: float = 10.0
    #: drain budget for scale-down
    drain_timeout_s: float = 10.0


@dataclass
class _PoolState:
    breach_streak: int = 0
    idle_streak: int = 0
    last_action_t: float = -math.inf
    last_direction: Optional[str] = None
    spawned: int = 0
    last_shed: Dict[str, int] = field(default_factory=dict)
    last_total: Dict[str, int] = field(default_factory=dict)


class Autoscaler:
    """Scales a :class:`~.fleet.ServingFleet`'s role pools from the
    registry signals the router aggregates.

    Parameters
    ----------
    fleet : the running ServingFleet (its pump loop keeps the health
        snapshots the signals are read from fresh).
    replica_factory : ``(replica_id, role) -> InferenceServer`` —
        builds an UNSTARTED server for a scale-up;
        :meth:`~.fleet.ServingFleet.add_replica` starts it.
    pools : pools to manage.  A pool spec is a bare role
        (``"decode"``) or a tenant-scoped ``"model:role"``
        (:func:`~.pools.split_pool`), so a multi-tenant fleet sizes
        each (model, phase) pool independently.  Defaults to the
        distinct (model, role) combinations the fleet's replicas
        advertise — a homogeneous single-model fleet scales its one
        ``both`` pool exactly as before.
    policy / policies : one shared :class:`AutoscalePolicy` or a
        per-pool dict.
    """

    def __init__(self, fleet, replica_factory: Callable[[str, str],
                                                        object],
                 policy: Optional[AutoscalePolicy] = None,
                 policies: Optional[Dict[str, AutoscalePolicy]] = None,
                 pools: Optional[Sequence[str]] = None,
                 signal_source: str = "slo",
                 clock: Callable[[], float] = time.monotonic):
        if signal_source not in ("raw", "slo"):
            raise ValueError(f"signal_source {signal_source!r} not "
                             f"raw|slo")
        self.fleet = fleet
        self.replica_factory = replica_factory
        if pools is None:
            combos = set()
            for s in fleet.servers.values():
                role = getattr(s, "role", "both")
                m = getattr(s, "model_name", None)
                combos.add(role if m is None else f"{m}:{role}")
            pools = tuple(sorted(combos))
        self.pools = tuple(pools)
        base = policy or AutoscalePolicy()
        self.policies = {p: (policies or {}).get(p, base)
                         for p in self.pools}
        self._clock = clock
        self._state = {p: _PoolState() for p in self.pools}
        #: structured decision log (every entry also hits the counter
        #: + the process log)
        self.decisions: List[dict] = []
        self._decisions_total = \
            fleet.router.metrics.registry.counter(
                "bigdl_autoscale_decisions_total",
                "autoscaler actions per pool and direction",
                labels=("pool", "direction"))
        #: "slo" (the default) evaluates the breach predicates as SLO
        #: rules over a MetricRecorder — identical thresholds/
        #: hysteresis/cooldown semantics, but every breach/recovery is
        #: a structured Alert + ``bigdl_alerts_total`` transition, and
        #: the per-pool signal history is queryable.  "raw" is the
        #:  pre-SLO inline-comparison path, kept as the fallback.
        self.signal_source = signal_source
        self.slo_engine = None
        self._slo_recorder = None
        self._pool_rules: Dict[str, Tuple[str, ...]] = {}
        if signal_source == "slo":
            self._build_slo_engine()

    # ------------------------------------------------------ slo plumbing
    def _build_slo_engine(self):
        from ..telemetry import metric_names as M
        from ..telemetry.slo import SloEngine, SloRule
        from ..telemetry.timeseries import MetricRecorder

        self._slo_recorder = MetricRecorder(clock=self._clock)
        self.slo_engine = SloEngine(
            self._slo_recorder,
            registry=self.fleet.router.metrics.registry,
            clock=self._clock)
        for pool in self.pools:
            policy = self.policies[pool]
            L = {"pool": pool}
            # one rule per raw breach predicate, SAME thresholds, with
            # for/resolve_intervals=1: the autoscaler's own
            # breach_streak/sustain keeps hysteresis semantics
            # IDENTICAL to the raw path (one firing == one raw
            # breach).  staleness_s=0.0 means ONLY a signal fed this
            # very round yields a verdict — the recorder's staleness
            # gate IS the traffic-activity gate (an inactive pool's
            # p99/queue are simply not refreshed, so their rules
            # render no verdict and the breach list excludes them)
            rules = [
                SloRule(name=f"autoscale/{pool}/p99",
                        family=M.AUTOSCALE_POOL_P99_SECONDS, labels=L,
                        kind="threshold", reduce="last", op=">=",
                        threshold=policy.p99_high_s,
                        window_s=3600.0, staleness_s=0.0,
                        description=f"{pool} p99 >= "
                                    f"{policy.p99_high_s}s"),
                SloRule(name=f"autoscale/{pool}/shed",
                        family=M.AUTOSCALE_POOL_SHED_RATE, labels=L,
                        kind="threshold", reduce="last", op=">=",
                        threshold=policy.shed_high,
                        window_s=3600.0, staleness_s=0.0,
                        description=f"{pool} shed rate >= "
                                    f"{policy.shed_high}"),
                SloRule(name=f"autoscale/{pool}/queue",
                        family=M.AUTOSCALE_POOL_QUEUE_DEPTH, labels=L,
                        kind="threshold", reduce="last", op=">=",
                        threshold=policy.queue_high,
                        window_s=3600.0, staleness_s=0.0,
                        description=f"{pool} queue >= "
                                    f"{policy.queue_high}"),
                SloRule(name=f"autoscale/{pool}/kv",
                        family=M.AUTOSCALE_POOL_KV_OCCUPANCY,
                        labels=L, kind="threshold", reduce="last",
                        op=">=",
                        threshold=policy.kv_occupancy_high,
                        window_s=3600.0, staleness_s=0.0,
                        description=f"{pool} kv occupancy >= "
                                    f"{policy.kv_occupancy_high}"),
            ]
            for rule in rules:
                self.slo_engine.add_rule(rule)
            self._pool_rules[pool] = tuple(r.name for r in rules)

    def _slo_feed(self, pool: str, sig: dict, active: bool,
                  now: float):
        """Feed this round's pool signals into the recorder.  The
        traffic-activity gate becomes the recorder's STALENESS gate:
        over no fresh traffic the windowed p99/queue are stale
        history, so they are simply not refreshed and their rules
        render no verdict (never a breach).  Shed/KV are refreshed
        unconditionally — a quiet pool's shed rate is honestly 0 and
        occupancy is held state, not history."""
        from ..telemetry import metric_names as M

        r = self._slo_recorder
        L = {"pool": pool}
        if active:
            r.observe(M.AUTOSCALE_POOL_P99_SECONDS, sig["p99_s"],
                      labels=L, now=now)
            r.observe(M.AUTOSCALE_POOL_QUEUE_DEPTH,
                      sig["queue_depth"], labels=L, now=now)
        # the raw predicate is (shed_rate >= high AND shed_delta > 0):
        # a window with no shed events reads 0.0, never a breach
        r.observe(M.AUTOSCALE_POOL_SHED_RATE,
                  sig["shed_rate"] if sig["shed_delta"] > 0 else 0.0,
                  labels=L, now=now)
        r.observe(M.AUTOSCALE_POOL_KV_OCCUPANCY, sig["kv_occupancy"],
                  labels=L, now=now)
        # cumulative pool counters: the error-budget burn-rate view
        # (default_serving_rules) and any scraper ride these
        st = self._state[pool]
        r.observe(M.AUTOSCALE_POOL_SHED_TOTAL,
                  float(sum(st.last_shed.values())), labels=L,
                  kind="counter", now=now)
        r.observe(M.AUTOSCALE_POOL_REQUESTS_TOTAL,
                  float(sum(st.last_total.values())), labels=L,
                  kind="counter", now=now)

    def _slo_breaches(self, pool: str, now: float) -> List[str]:
        """The pool's firing rules WITH a verdict this round, as
        breach descriptions — the SLO verdicts the control logic
        consumes in place of the raw comparisons.  A rule frozen by
        the staleness gate (inactive pool: p99/queue not refreshed)
        contributes nothing, exactly the raw activity gate."""
        out = []
        for a in self.slo_engine.firing(self._pool_rules[pool]):
            if a.get("last_verdict_at") is None \
                    or a["last_verdict_at"] < now:
                continue
            if isinstance(a["value"], (int, float)):
                out.append(f"{a['rule']}: {a['description']} "
                           f"(value={a['value']:.4g})")
            else:
                out.append(f"{a['rule']}: {a['description']}")
        return out

    # ------------------------------------------------------------ signals
    def _pool_health(self, pool: str) -> Dict[str, dict]:
        """Health snapshots of the replicas serving ``pool`` — the
        SAME view the router routes on.  A replica with no snapshot
        yet contributes nothing (it is not routable either)."""
        model, role = split_pool(pool)
        out = {}
        for rid in self.fleet.servers:
            h = self.fleet.router.health_of(rid)
            if h is not None and serves_phase(h.get("role"), role) \
                    and (model is None or h.get("model") == model):
                out[rid] = h
        return out

    def pool_signals(self, pool: str) -> dict:
        """Aggregate one pool's control signals from published health:
        worst p99, shed count/rate over the window since the last
        evaluation, summed queue depth, worst KV occupancy."""
        st = self._state[pool]
        health = self._pool_health(pool)
        p99 = max((h.get("p99_s") or 0.0 for h in health.values()),
                  default=0.0)
        queue = sum(int(h.get("queue_depth", 0))
                    for h in health.values())
        kv_occ = max((h.get("kv_occupancy") or 0.0
                      for h in health.values()), default=0.0)
        shed_d = total_d = 0
        for rid, h in health.items():
            shed_d += max(0, int(h.get("shed_total", 0))
                          - st.last_shed.get(rid, 0))
            total_d += max(0, int(h.get("requests_total", 0))
                           - st.last_total.get(rid, 0))
            st.last_shed[rid] = int(h.get("shed_total", 0))
            st.last_total[rid] = int(h.get("requests_total", 0))
        return {
            "pool": pool,
            "replicas": self.pool_size(pool),
            "p99_s": p99,
            "queue_depth": queue,
            "kv_occupancy": kv_occ,
            "shed_delta": shed_d,
            "requests_delta": total_d,
            "shed_rate": (shed_d / total_d) if total_d else 0.0,
        }

    def pool_size(self, pool: str) -> int:
        """Replicas whose EXACT role (and model, for a tenant-scoped
        pool) matches ``pool`` — what scaling actuates (a ``both``
        member is never retired by a phase pool's scale-down, and one
        model's pool never retires another model's replica)."""
        model, role = split_pool(pool)
        return sum(
            1 for s in self.fleet.servers.values()
            if getattr(s, "role", "both") == role
            and (model is None
                 or getattr(s, "model_name", None) == model))

    def replica_counts(self) -> Dict[str, int]:
        """{pool: replica count} — one timeline sample for the bench."""
        return {p: self.pool_size(p) for p in self.pools}

    # ------------------------------------------------------------ control
    def _record(self, pool: str, direction: str, replica: str,
                reason: str, signals: dict):
        event = {"at": self._clock(), "pool": pool,
                 "direction": direction, "replica": replica,
                 "reason": reason, "signals": signals}
        self.decisions.append(event)
        self._decisions_total.labels(pool=pool,
                                     direction=direction).inc()
        _record_change(f"autoscale_{direction}", str(reason),
                       source="serving.autoscale", pool=pool,
                       replica=replica)
        log.info("autoscale: %s %s (%s) — %s", direction, replica,
                 pool, reason)

    def _scale_up(self, pool: str, reason: str, signals: dict):
        st = self._state[pool]
        st.spawned += 1
        # "model:role" pools keep the fleet's dash-separated replica
        # naming ("alpha:decode" spawns "alpha-decode-as1")
        rid = f"{pool.replace(':', '-')}-as{st.spawned}"
        server = self.replica_factory(rid, pool)
        self.fleet.add_replica(rid, server)
        st.last_action_t = self._clock()
        st.last_direction = "up"
        st.breach_streak = st.idle_streak = 0
        self._record(pool, "up", rid, reason, signals)

    def _retire_candidate(self, pool: str) -> Optional[str]:
        """Last-in-first-out: prefer autoscaler-spawned replicas (the
        capacity this loop added), newest name first."""
        model, role = split_pool(pool)
        exact = sorted(
            rid for rid, s in self.fleet.servers.items()
            if getattr(s, "role", "both") == role
            and (model is None
                 or getattr(s, "model_name", None) == model))
        if not exact:
            return None
        marker = f"{pool.replace(':', '-')}-as"
        spawned = [r for r in exact if marker in r]
        return (spawned or exact)[-1]

    def _scale_down(self, pool: str, reason: str, signals: dict):
        rid = self._retire_candidate(pool)
        if rid is None:
            return
        st = self._state[pool]
        policy = self.policies[pool]
        self.fleet.remove_replica(
            rid, timeout=policy.drain_timeout_s, drain=True)
        st.last_action_t = self._clock()
        st.last_direction = "down"
        st.breach_streak = st.idle_streak = 0
        self._record(pool, "down", rid, reason, signals)

    def evaluate_once(self) -> List[dict]:
        """One control round over every managed pool.  Returns the
        decisions taken this round (possibly empty — sustained-breach
        hysteresis and cooldowns mean MOST rounds act on nothing).

        With ``signal_source="slo"`` (the default) the breach
        predicates are SLO rules: signals feed the recorder (gated —
        an inactive pool's p99/queue are not refreshed, so their
        rules render no verdict), ONE engine evaluation fires/resolves
        the per-pool rules as structured alerts, and the breach list
        is the pool's fresh firing set — identical decisions to the
        raw path, now alert-visible.  Scale-down idleness stays a raw
        capacity read in both modes (quiet is not an SLO breach)."""
        now = self._clock()
        signals: Dict[str, dict] = {}
        actives: Dict[str, bool] = {}
        for pool in self.pools:
            policy = self.policies[pool]
            sig = signals[pool] = self.pool_signals(pool)
            gate = policy.idle_requests_delta
            actives[pool] = (gate is None
                             or sig["requests_delta"] > gate)
            if self.slo_engine is not None:
                self._slo_feed(pool, sig, actives[pool], now)
        if self.slo_engine is not None:
            self.slo_engine.evaluate(now=now)
        taken = []
        for pool in self.pools:
            policy = self.policies[pool]
            st = self._state[pool]
            sig = signals[pool]
            active = actives[pool]
            if self.slo_engine is not None:
                breaches = self._slo_breaches(pool, now)
            else:
                breaches = []
                if active and sig["p99_s"] >= policy.p99_high_s:
                    breaches.append(f"p99 {sig['p99_s']:.3f}s >= "
                                    f"{policy.p99_high_s}s")
                if sig["shed_rate"] >= policy.shed_high \
                        and sig["shed_delta"] > 0:
                    breaches.append(
                        f"shed rate {sig['shed_rate']:.3f} >= "
                        f"{policy.shed_high}")
                if active and sig["queue_depth"] >= policy.queue_high:
                    breaches.append(f"queue {sig['queue_depth']} >= "
                                    f"{policy.queue_high}")
                if sig["kv_occupancy"] >= policy.kv_occupancy_high:
                    breaches.append(
                        f"kv occupancy {sig['kv_occupancy']:.2f} >= "
                        f"{policy.kv_occupancy_high}")
            idle = (sig["shed_delta"] == 0
                    and sig["queue_depth"] <= policy.queue_idle
                    and sig["kv_occupancy"]
                    <= policy.kv_occupancy_idle
                    and (not active
                         or sig["p99_s"] <= policy.p99_idle_s))
            st.breach_streak = st.breach_streak + 1 if breaches else 0
            st.idle_streak = st.idle_streak + 1 if idle else 0
            if now - st.last_action_t < policy.cooldown_s:
                continue  # hold: the last action is still settling
            before = len(self.decisions)
            if breaches and st.breach_streak >= policy.sustain \
                    and sig["replicas"] < policy.max_replicas:
                self._scale_up(pool, "; ".join(breaches), sig)
            elif idle and st.idle_streak >= policy.idle_sustain \
                    and sig["replicas"] > policy.min_replicas:
                self._scale_down(
                    pool,
                    f"idle: p99 {sig['p99_s']:.3f}s, no shed, "
                    f"queue {sig['queue_depth']}", sig)
            taken.extend(self.decisions[before:])
        return taken
