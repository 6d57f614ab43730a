"""Failover router over a fleet of serving replicas
(counterpart of ``bigdl_tpu/serving/router.py``).

One :class:`FleetRouter` fronts N :class:`~.server.InferenceServer`
replicas and owns the three cluster behaviors a single server cannot
have:

* **Live-set maintenance** — replica membership rides the same
  machinery as training gangs (:class:`~bigdl_tpu_torch.resilience.elastic
  .ElasticCoordinator`): every replica heartbeats and publishes a
  health snapshot (ready, queue depth, breaker state, p99) through the
  elastic KV transport, membership is versioned by incarnation
  numbers, and every reconfiguration is an incarnation bump.  The
  router ejects a replica that misses heartbeats or reports its
  breaker open (eviction marker + membership proposal, exactly the
  shrink path training takes on a dead host) and re-admits it when its
  beats resume and it reports ready again.
* **Failover dispatch** — requests go to the *least-loaded* ready
  replica (router-tracked in-flight count + the replica's published
  queue depth).  A request that comes back with a retryable status
  (INTERNAL_ERROR / UNAVAILABLE / OVERLOADED / CANCELLED) retries on a
  *different* replica with the **remaining** deadline budget — the
  deadline is propagated, never reset — until the budget or the
  attempt bound runs out.  Per-replica circuit breakers
  (:class:`~.breaker.CircuitBreaker`, the same state machine the
  server wraps its device step in) stop the router from hammering a
  replica that keeps failing, independent of membership.
* **Tail-latency hedging** — optionally, when the primary has not
  answered within a p99-derived delay, the request is *duplicated* to
  a second replica; the first usable response wins and the loser is
  abandoned (its result is discarded on arrival — a dispatched device
  batch is not interruptible).  ``hedges_fired`` / ``hedges_won``
  count it in the router's :class:`~.metrics.ServingMetrics`.

Every request resolves to exactly one typed
:class:`~.status.ServeResult`, same contract as the single server —
the fleet adds failure *routing*, never failure *hiding*.
"""
from __future__ import annotations

import json
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional, Tuple

from ..telemetry.events import record_change as _record_change
from .breaker import CircuitBreaker, REJECT
from .metrics import ServingMetrics
from .status import ServeFuture, ServeResult, Status

log = logging.getLogger("bigdl_tpu")

#: KV key prefix for replica health snapshots (next to the
#: coordinator's ``hb/`` beats; the payload carries the incarnation it
#: was published under)
HEALTH_PREFIX = "srvhealth/"

#: statuses worth retrying on a different replica — the *replica*
#: failed or refused, the request itself is fine
RETRYABLE_STATUSES = frozenset((
    Status.INTERNAL_ERROR, Status.UNAVAILABLE, Status.OVERLOADED,
    Status.CANCELLED,
))


def read_health(transport, replica: str) -> Optional[dict]:
    """The newest health snapshot ``replica`` published, or None."""
    raw = transport.get(HEALTH_PREFIX + str(replica))
    if raw is None:
        return None
    try:
        return json.loads(raw)
    except ValueError:
        return None


class FleetRouter:
    """Health-aware failover router — see the module docstring.

    Parameters
    ----------
    replicas : id → the local server handle to dispatch to (in a
        multi-process fleet these are RPC stubs; the contract is just
        ``submit`` / ``submit_generate`` returning a ServeFuture).
    coordinator : the router's own ElasticCoordinator over the fleet
        transport (membership reads + eject/readmit proposals).
    max_attempts : dispatch attempts per request (primary + retries).
    default_deadline_s : per-request deadline when ``submit`` gives
        none (None = no deadline; retries then bound only by attempts).
    hedge : enable tail-latency hedging.
    hedge_delay_s : fixed hedge delay; None derives it from the
        router's own observed p99 (clamped to ``hedge_min_delay_s``,
        with ``hedge_default_delay_s`` before any sample exists).
    breaker_factory : per-replica router-side breaker constructor.
    max_workers : router dispatch pool size (each in-flight request
        occupies one worker while it waits).
    """

    def __init__(self, replicas: Dict[str, object], coordinator, *,
                 metrics: Optional[ServingMetrics] = None,
                 max_attempts: int = 3,
                 default_deadline_s: Optional[float] = None,
                 hedge: bool = False,
                 hedge_delay_s: Optional[float] = None,
                 hedge_min_delay_s: float = 0.005,
                 hedge_default_delay_s: float = 0.050,
                 hedge_decode: bool = False,
                 disaggregate: bool = False,
                 breaker_factory: Optional[Callable[[], CircuitBreaker]]
                 = None,
                 max_workers: int = 16,
                 tracing=None,
                 model_registry=None,
                 admission=None,
                 default_model: Optional[str] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.replicas = dict(replicas)
        self.coordinator = coordinator
        self.metrics = metrics or ServingMetrics()
        #: multi-tenant routing (serving.registry): ``model_registry``
        #: answers "does this model exist" at admission and per attempt
        #: (a miss is typed NOT_FOUND — no queue slot, no retry burn);
        #: ``admission`` enforces per-tenant weighted quotas with fair
        #: shedding before global shedding.  Both None = single-model
        #: fleet, zero new cost on the request path.
        self.model_registry = model_registry
        self.admission = admission
        self.default_model = default_model
        self.max_attempts = max(1, int(max_attempts))
        self.default_deadline_s = default_deadline_s
        self.hedge = bool(hedge)
        self.hedge_delay_s = hedge_delay_s
        self.hedge_min_delay_s = float(hedge_min_delay_s)
        self.hedge_default_delay_s = float(hedge_default_delay_s)
        #: hedging a DECODE-phase request duplicates a long
        #: memory-bandwidth-bound stream and doubles its KV-pool hold for
        #: a tail win that belongs to prefill — suppressed by default;
        #: suppressions are counted
        #: (``bigdl_serving_hedges_total{event="suppressed"}``)
        self.hedge_decode = bool(hedge_decode)
        #: split ``submit_generate`` into a prefill dispatch (returns
        #: the KV handoff + first token) and a decode dispatch
        #: (streams the rest), each least-loaded within its own role
        #: pool under the same deadline-budget/retry/breaker machinery
        self.disaggregate = bool(disaggregate)
        self._breaker_factory = breaker_factory or CircuitBreaker
        #: distributed request tracing (serving.request_trace
        #: .RequestTracer): mints a TraceContext per request, records
        #: the root/attempt spans, tail-samples at completion and
        #: stitches kept traces from the replicas' KV fragments.
        #: None = tracing off, zero per-request cost.
        self.tracing = tracing
        self._clock = clock
        self._lock = threading.Lock()
        # optimistic until the first refresh: every configured replica
        # is a member (matches the fleet's bootstrap membership)
        self._members: Tuple[str, ...] = tuple(sorted(self.replicas))
        self._health: Dict[str, dict] = {}
        self._inflight: Dict[str, int] = {r: 0 for r in self.replicas}
        self._breakers: Dict[str, CircuitBreaker] = {}
        # replica -> reason: marked by the SLO health monitor on a
        # per-replica rule breach.  A degraded replica is unroutable
        # and EJECTED at the next refresh (the breaker-open path), and
        # is not re-admitted until the mark clears
        self._degraded: Dict[str, str] = {}
        self._dispatch_total = self.metrics.registry.counter(
            "bigdl_fleet_dispatch_total",
            "router dispatches per replica and terminal status",
            labels=("replica", "status"))
        self._tenant_dispatch = self.metrics.registry.counter(
            "bigdl_tenant_dispatch_total",
            "router dispatches per tenant, replica and terminal "
            "status", labels=("tenant", "replica", "status"))
        self._tenant_admission = self.metrics.registry.counter(
            "bigdl_tenant_admission_total",
            "admission decisions per tenant (admitted | tenant_quota "
            "| global | not_found)", labels=("tenant", "decision"))
        self._tenant_inflight = self.metrics.registry.gauge(
            "bigdl_tenant_inflight",
            "admitted requests currently in flight per tenant",
            labels=("tenant",))
        self.ejections = 0
        self.readmissions = 0
        self._pool = ThreadPoolExecutor(
            max_workers=int(max_workers),
            thread_name_prefix="bigdl-fleet-router")
        self._closed = False

    # ------------------------------------------------------------ membership
    @property
    def members(self) -> Tuple[str, ...]:
        with self._lock:
            return self._members

    def live(self) -> Tuple[str, ...]:
        """Members currently routable: health known-ready (or not yet
        reported), not SLO-degraded, and router-side breaker not
        rejecting."""
        with self._lock:
            members, health = self._members, dict(self._health)
            degraded = set(self._degraded)
        out = []
        for r in members:
            if r in degraded:
                continue
            h = health.get(r)
            if h is not None and not h.get("ready", True):
                continue
            if self._breaker(r).state == "open":
                continue
            out.append(r)
        return tuple(out)

    # -------------------------------------------------- SLO degradation
    def mark_degraded(self, replica: str, reason: str = "") -> None:
        """An SLO rule breached on this replica (serving/health.py):
        stop routing to it NOW and eject it from membership at the
        next refresh — the same machinery a reported-open breaker
        rides.  Idempotent."""
        with self._lock:
            known = replica in self.replicas
            already = replica in self._degraded
            self._degraded[str(replica)] = str(reason)
        if known and not already:
            log.warning("fleet: replica %s marked DEGRADED (%s)",
                        replica, reason or "slo breach")

    def clear_degraded(self, replica: str) -> None:
        """The breaching rule resolved: the replica may re-admit
        through the normal returner path (beats + reports ready)."""
        with self._lock:
            was = self._degraded.pop(str(replica), None)
        if was is not None:
            log.info("fleet: replica %s degradation cleared", replica)

    @property
    def degraded(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._degraded)

    def health_of(self, replica: str) -> Optional[dict]:
        with self._lock:
            return self._health.get(replica)

    def refresh(self):
        """One membership-maintenance round: re-read beats + health,
        eject members that missed heartbeats or report breaker-open,
        re-admit returners that beat again and report ready.  Called by
        the fleet's pump loop; idempotent and safe to call anytime."""
        c = self.coordinator
        n, members = c.membership()
        beats = c.beats()
        alive = c.alive(beats)
        health: Dict[str, dict] = {}
        for r in self.replicas:
            h = read_health(c.transport, r)
            if h is not None:
                health[r] = h
        with self._lock:
            degraded_marks = set(self._degraded)
        dead = [m for m in members if m not in alive]
        breaker_open = [
            m for m in members if m in alive
            and (health.get(m) or {}).get("breaker_state") == "open"]
        degraded = [m for m in members
                    if m in alive and m not in breaker_open
                    and m in degraded_marks]
        out = dead + breaker_open + degraded
        if out:
            survivors = [m for m in members if m not in out]
            if survivors:
                n2 = c.propose(
                    survivors,
                    f"fleet eject: dead={dead} "
                    f"breaker_open={breaker_open} "
                    f"degraded={degraded}", expect=n)
                if n2 is not None:
                    for m in out:
                        c.evict(m, "missed heartbeats" if m in dead
                                else ("slo degraded" if m in degraded
                                      else "breaker open"))
                    self.ejections += len(out)
                    log.warning(
                        "fleet: ejected %s (dead=%s breaker_open=%s "
                        "degraded=%s), incarnation %d members=%s",
                        out, dead, breaker_open, degraded, n2,
                        survivors)
                n, members = c.membership()
        rejoiners = [
            r for r in sorted(alive)
            if r not in members and r in self.replicas
            and r not in degraded_marks
            and (health.get(r) or {}).get("ready")]
        if rejoiners:
            grown = sorted(set(members) | set(rejoiners))
            n2 = c.propose(grown, f"fleet readmit: {rejoiners}",
                           expect=n)
            if n2 is not None:
                for r in rejoiners:
                    c.readmit(r)
                self.readmissions += len(rejoiners)
                log.warning("fleet: re-admitted %s, incarnation %d "
                            "members=%s", rejoiners, n2, grown)
                n, members = c.membership()
        with self._lock:
            self._members = tuple(sorted(members))
            self._health = health

    def add_replica(self, replica: str, handle) -> None:
        """Register a new dispatch target (autoscale scale-up): the
        replica joins the routable set once its agent beats and its
        health reports ready (the normal re-admission path)."""
        with self._lock:
            self.replicas[replica] = handle
            self._inflight.setdefault(replica, 0)

    def remove_replica(self, replica: str) -> None:
        """Deregister a retired replica and retire it from membership
        NOW (a planned retire must not wait out the heartbeat timeout
        like a death would)."""
        with self._lock:
            self.replicas.pop(replica, None)
            self._health.pop(replica, None)
            self._breakers.pop(replica, None)
            self._degraded.pop(replica, None)
        c = self.coordinator
        n, members = c.membership()
        if replica in members:
            survivors = [m for m in members if m != replica]
            if survivors:
                n2 = c.propose(survivors, f"fleet retire: {replica}",
                               expect=n)
                if n2 is not None:
                    c.evict(replica, "retired (scale-down)")
                    log.info("fleet: retired %s, incarnation %d "
                             "members=%s", replica, n2, survivors)
        with self._lock:
            self._members = tuple(m for m in self._members
                                  if m != replica)

    # ------------------------------------------------------------ dispatch
    def _breaker(self, replica: str) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(replica)
            if br is None:
                br = self._breakers[replica] = self._breaker_factory()
                # stamp the guarded replica so journal events from
                # this breaker's transitions carry a replica scope
                br.owner = replica
            return br

    def _pick(self, exclude=(), phase: Optional[str] = None,
              model: Optional[str] = None) -> Optional[str]:
        """Least-loaded ready member outside ``exclude`` whose router-
        side breaker admits traffic, optionally restricted to the
        replicas serving ``phase`` (``prefill`` | ``decode`` — role
        advertised in the health snapshot, unreported roles count as
        ``both``) and/or advertising ``model`` (multi-tenant routing:
        only replicas whose health snapshot names the model are
        candidates — a replica that has not reported cannot prove it
        serves the model and is skipped).  The breaker is only
        ``acquire``d on the replica actually chosen, so a half-open
        probe slot is never burned on a replica we don't dispatch to."""
        from .pools import serves_phase

        with self._lock:
            members = self._members
            health = dict(self._health)
            inflight = dict(self._inflight)
            degraded = set(self._degraded)
        ranked = []
        for r in members:
            if r in exclude or r not in self.replicas \
                    or r in degraded:
                continue
            h = health.get(r)
            if h is not None and not h.get("ready", True):
                continue
            if phase is not None and not serves_phase(
                    (h or {}).get("role"), phase):
                continue
            if model is not None \
                    and (h or {}).get("model") != model:
                continue
            load = inflight.get(r, 0) + int(
                (h or {}).get("queue_depth", 0))
            ranked.append((load, r))
        for _, r in sorted(ranked):
            if self._breaker(r).acquire() != REJECT:
                return r
        return None

    def pool_members(self, phase: str) -> Tuple[str, ...]:
        """Current members of one role pool (from the health view) —
        what the autoscaler sizes."""
        from .pools import serves_phase

        with self._lock:
            members = self._members
            health = dict(self._health)
        return tuple(sorted(
            r for r in members
            if serves_phase((health.get(r) or {}).get("role"), phase)))

    def _resolve(self, fut: ServeFuture, result: ServeResult,
                 t0: float, trace=None, tenant: Optional[str] = None):
        result.latency_s = self._clock() - t0
        kept = None
        if trace is not None:
            # tail sampling runs HERE, when the outcome is known: the
            # p99 reference excludes this sample (it is about to land;
            # amortized-cached — an exact sort per request would tax
            # the hot path O(window log window))
            p99 = self.metrics.latency_p99()
            kept = self.tracing.finish(
                trace, result.status.value,
                result.status is Status.OK, result.latency_s, p99)
            result.trace_id = trace.ctx.trace_id
        self.metrics.record(
            result.status, result.latency_s, result.queued_s,
            trace_id=(result.trace_id if kept else None),
            tenant=tenant)
        fut._resolve(result)

    def submit(self, feature,
               deadline_s: Optional[float] = None,
               model: Optional[str] = None,
               tenant: Optional[str] = None) -> ServeFuture:
        """Route one classification request across the fleet.  Returns
        a future that resolves to the winning replica's ServeResult
        (or a typed router-level failure).  ``model`` routes over the
        replicas advertising it (typed NOT_FOUND when unregistered);
        ``tenant`` names the quota the request admits under (defaults
        to the model name)."""
        return self._enqueue("classify", feature, None, deadline_s,
                             model=model, tenant=tenant)

    def submit_generate(self, prompt_ids, max_new: int,
                        eos_id: Optional[int] = None,
                        pad_id: Optional[int] = None,
                        deadline_s: Optional[float] = None,
                        model: Optional[str] = None,
                        tenant: Optional[str] = None
                        ) -> ServeFuture:
        """Route one generation request across the fleet."""
        return self._enqueue("generate", prompt_ids,
                             (int(max_new), eos_id, pad_id), deadline_s,
                             model=model, tenant=tenant)

    def _enqueue(self, kind, payload, opts, deadline_s,
                 model: Optional[str] = None,
                 tenant: Optional[str] = None) -> ServeFuture:
        fut = ServeFuture()
        now = self._clock()
        model = model if model is not None else self.default_model
        tenant = tenant if tenant is not None else model
        # admission-order contract: registry miss resolves typed
        # NOT_FOUND before any queue slot or quota charge; then the
        # tenant's deadline budget clamps; then the weighted quota
        # check admits or sheds — all before the dispatch pool sees
        # the request
        version = None
        if self.model_registry is not None and model is not None:
            version = self.model_registry.lookup(model)
            if version is None:
                if tenant is not None:
                    self._tenant_admission.labels(
                        tenant=tenant, decision="not_found").inc()
                    self.metrics.record_shed(tenant, "not_found")
                self._resolve(fut, ServeResult(
                    Status.NOT_FOUND,
                    error=f"model {model!r} is not registered"),
                    now, tenant=tenant)
                return fut
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        if self.admission is not None and tenant is not None:
            deadline_s = self.admission.deadline_for(tenant, deadline_s)
        deadline = None if deadline_s is None \
            else now + float(deadline_s)
        if self._closed:
            self._resolve(fut, ServeResult(
                Status.UNAVAILABLE, error="router closed"), now,
                tenant=tenant)
            return fut
        if self.admission is not None and tenant is not None:
            ok, decision = self.admission.try_admit(tenant)
            self._tenant_admission.labels(
                tenant=tenant, decision=decision).inc()
            if not ok:
                # weighted fair shedding: "tenant_quota" sheds ONLY the
                # over-quota tenant; "global" is fleet-wide exhaustion
                self.metrics.record_shed(tenant, decision)
                # journaled throttled per (tenant, reason): a flood
                # must not evict the deploy that explains it out of
                # the bounded ring
                _record_change("tenant_shed", str(decision),
                               source="serving.router", tenant=tenant,
                               throttle_key=f"{tenant}/{decision}")
                self._resolve(fut, ServeResult(
                    Status.OVERLOADED,
                    error=f"tenant {tenant!r} admission refused "
                          f"({decision})"), now, tenant=tenant)
                return fut
            self._tenant_inflight.labels(tenant=tenant).set(
                float(self.admission.inflight(tenant)))

            def _release(_f, _tenant=tenant):
                self.admission.release(_tenant)
                self._tenant_inflight.labels(tenant=_tenant).set(
                    float(self.admission.inflight(_tenant)))

            # the slot returns exactly when the single-assignment
            # future resolves — typed shed, OK, cancel, all paths
            fut.add_done_callback(_release)
        # the TraceContext is minted HERE — at submit, before any
        # dispatch — so router-pool wait is part of the trace too
        trace = self.tracing.begin(kind, deadline_s) \
            if self.tracing is not None else None
        if trace is not None and (tenant is not None
                                  or model is not None):
            trace.ctx.tenant = tenant
            trace.ctx.model = model
            trace.ctx.model_version = version
        drive = self._drive
        if kind == "generate" and self.disaggregate:
            drive = self._drive_disagg
        try:
            self._pool.submit(drive, kind, payload, opts,
                              deadline, fut, now, trace, model, tenant)
        except RuntimeError:  # closed between the check and the submit
            self._resolve(fut, ServeResult(
                Status.UNAVAILABLE, error="router closed"), now,
                trace, tenant=tenant)
        return fut

    def _dispatch(self, replica: str, kind, payload, opts,
                  remaining: Optional[float],
                  trace=None, tenant: Optional[str] = None) -> ServeFuture:
        with self._lock:
            client = self.replicas.get(replica)
            if client is None:
                # retired (autoscale scale-down) between _pick and
                # here: resolve typed-retryable, never KeyError in the
                # drive thread (which would leave the future hanging)
                inner = ServeFuture()
                inner._resolve(ServeResult(
                    Status.UNAVAILABLE,
                    error=f"replica {replica} retired"))
                return inner
            self._inflight[replica] = self._inflight.get(replica, 0) + 1

        def on_done(f, _replica=replica):
            with self._lock:
                self._inflight[_replica] -= 1
            res = f._result
            br = self._breaker(_replica)
            if res is not None and res.status is Status.OK:
                br.record_success()
            else:
                # anything else — failure, shed, cancel, blown deadline
                # — reads as "stop preferring this replica"; the
                # breaker's half-open probe re-tests it later
                br.record_failure()
            if res is not None:
                self._dispatch_total.labels(
                    replica=_replica, status=res.status.value).inc()
                if tenant is not None:
                    self._tenant_dispatch.labels(
                        tenant=tenant, replica=_replica,
                        status=res.status.value).inc()

        # the forked context rides the dispatch only when tracing is
        # on — untraced dispatch keeps the pre-trace call signature
        # (third-party replica stubs need not know the kwarg)
        tkw = {} if trace is None else {"trace": trace.to_wire()}
        try:
            if kind == "classify":
                inner = client.submit(payload, deadline_s=remaining,
                                      **tkw)
            elif kind == "prefill":
                inner = client.submit_prefill(payload,
                                              deadline_s=remaining,
                                              **tkw)
            elif kind == "decode":
                max_new, eos_id, pad_id = opts
                inner = client.submit_decode(
                    payload, max_new, eos_id=eos_id, pad_id=pad_id,
                    deadline_s=remaining, **tkw)
            else:
                max_new, eos_id, pad_id = opts
                inner = client.submit_generate(
                    payload, max_new, eos_id=eos_id, pad_id=pad_id,
                    deadline_s=remaining, **tkw)
        except Exception as e:
            # a submit() that raises (malformed request, stopped
            # handle) resolves typed instead of leaking out of the
            # router pool
            inner = ServeFuture()
            with self._lock:
                self._inflight[replica] -= 1
            self._breaker(replica).record_failure()
            inner._resolve(ServeResult(
                Status.INTERNAL_ERROR,
                error=f"submit to {replica} raised "
                      f"{type(e).__name__}: {e}"))
            return inner
        inner.add_done_callback(on_done)
        return inner

    def _hedge_delay(self) -> float:
        if self.hedge_delay_s is not None:
            return float(self.hedge_delay_s)
        # amortized-cached p99 (metrics.latency_p99): the exact-window
        # quantile sorts up to 8192 samples — per-dispatch that tax
        # compounds exactly on the latency path hedging exists to cut
        p99 = self.metrics.latency_p99()
        if p99 is None or p99 <= 0:
            return self.hedge_default_delay_s
        return max(self.hedge_min_delay_s, float(p99))

    def _await_first_usable(self, pending: Dict[str, ServeFuture],
                            deadline: Optional[float],
                            hedge_replica: Optional[str],
                            on_result=None
                            ) -> Tuple[Optional[ServeResult],
                                       Optional[str]]:
        """Wait until one pending future resolves OK (first usable
        response wins; a failed one keeps the wait going while others
        are still out), all of them fail (return the last failure), or
        the deadline passes (return ``(None, None)``).  ``on_result``
        observes every resolved (replica, result) as it lands — the
        tracer closes attempt spans through it."""
        event = threading.Event()
        for f in pending.values():
            f.add_done_callback(lambda _f: event.set())
        last: Optional[ServeResult] = None
        last_replica: Optional[str] = None
        while pending:
            for r in [r for r, f in pending.items() if f.done()]:
                res = pending.pop(r)._result
                if on_result is not None:
                    on_result(r, res)
                if res.status is Status.OK:
                    if hedge_replica is not None \
                            and r == hedge_replica:
                        self.metrics.record_hedge(won=True)
                    return res, r
                last, last_replica = res, r
            if not pending:
                break
            now = self._clock()
            if deadline is not None and now >= deadline:
                return None, None
            timeout = 0.05 if deadline is None \
                else min(0.05, deadline - now)
            event.wait(timeout)
            event.clear()
        return last, last_replica

    #: which role pool each dispatch kind routes within (classify and
    #: whole generates go anywhere)
    _KIND_PHASE = {"prefill": "prefill", "decode": "decode"}

    def _attempt_loop(self, kind, payload, opts,
                      deadline: Optional[float],
                      trace=None, model: Optional[str] = None,
                      tenant: Optional[str] = None) -> ServeResult:
        """The failover core: least-loaded dispatch within the kind's
        role pool, retryable outcomes retried on a different replica
        with the REMAINING deadline budget, optional hedging.  Always
        returns a typed ServeResult — the disaggregated drive chains
        two of these (prefill, then decode) under one budget.

        ``model`` restricts every pick to replicas advertising it and
        re-checks the registry each attempt, so an entry that vanishes
        mid-flight (unregister_model_mid_flight) converts the request
        to typed NOT_FOUND instead of retrying forever against a pool
        that no longer serves it.

        With ``trace``, every dispatch (primary, retry, hedge) forks
        the request's TraceContext with the budget that remains at
        fork time; attempt spans close with their terminal status, a
        hedge's discarded duplicate closes ``hedge_outcome=lost`` AT
        DISCARD (never an orphan), and the winner is labeled ``won``.
        """
        tr = self.tracing if trace is not None else None
        phase = self._KIND_PHASE.get(kind)
        hedge_ok = self.hedge and (kind != "decode"
                                   or self.hedge_decode)
        tried = set()
        attempts = 0
        last: Optional[ServeResult] = None
        while True:
            now = self._clock()
            if deadline is not None and now >= deadline:
                return ServeResult(
                    Status.DEADLINE_EXCEEDED,
                    error=f"deadline budget exhausted after "
                          f"{attempts} attempt(s)")
            if attempts >= self.max_attempts:
                return last or ServeResult(
                    Status.UNAVAILABLE,
                    error=f"no attempt succeeded in "
                          f"{self.max_attempts}")
            if model is not None and self.model_registry is not None \
                    and self.model_registry.lookup(model) is None:
                # the registry entry vanished with this request in
                # flight: typed NOT_FOUND, no further retry burn
                if tenant is not None:
                    self.metrics.record_shed(tenant, "not_found")
                return ServeResult(
                    Status.NOT_FOUND,
                    error=f"model {model!r} unregistered mid-flight "
                          f"after {attempts} attempt(s)")
            primary = self._pick(exclude=tried, phase=phase,
                                 model=model)
            if primary is None:
                # nothing routable outside the tried set: degrade
                # typed (the single-server OVERLOADED/UNAVAILABLE
                # discipline, fleet-wide)
                return last or ServeResult(
                    Status.UNAVAILABLE,
                    error="no ready replica"
                          + (f" in the {phase} pool" if phase else "")
                          + (f" advertising model {model!r}"
                             if model else ""))
            if attempts > 0:
                self.metrics.record_retry()
            attempts += 1
            remaining = None if deadline is None else deadline - now
            ctxs: Dict[str, object] = {}
            if tr is not None:
                ctxs[primary] = tr.attempt_begin(
                    trace, primary, kind, remaining)
            pending = {primary: self._dispatch(
                primary, kind, payload, opts, remaining,
                trace=ctxs.get(primary), tenant=tenant)}
            hedge_replica = None
            if self.hedge and not pending[primary].done():
                delay = self._hedge_delay()
                if remaining is None or delay < remaining:
                    done_early = threading.Event()
                    pending[primary].add_done_callback(
                        lambda _f: done_early.set())
                    if not done_early.wait(delay):
                        if not hedge_ok:
                            # the hedge WOULD have fired — a decode
                            # duplicate doubles device memory + KV-pool
                            # hold, so count the suppression and carry on
                            self.metrics.record_hedge_suppressed()
                        else:
                            rem2 = None if deadline is None \
                                else deadline - self._clock()
                            if rem2 is None or rem2 > 0:
                                hedge_replica = self._pick(
                                    exclude=tried | {primary},
                                    phase=phase, model=model)
                            if hedge_replica is not None:
                                self.metrics.record_hedge(won=False)
                                if tr is not None:
                                    ctxs[hedge_replica] = \
                                        tr.attempt_begin(
                                            trace, hedge_replica,
                                            kind, rem2, hedge=True)
                                pending[hedge_replica] = \
                                    self._dispatch(
                                        hedge_replica, kind, payload,
                                        opts, rem2,
                                        trace=ctxs.get(hedge_replica),
                                        tenant=tenant)
            statuses: Dict[str, str] = {}
            on_result = None
            if tr is not None:
                def on_result(r, res, _st=statuses):
                    _st[r] = res.status.value if res is not None \
                        else "abandoned"
            result, via = self._await_first_usable(
                pending, deadline, hedge_replica, on_result=on_result)
            if tr is not None:
                hedged_race = len(ctxs) > 1
                for r, ctx in ctxs.items():
                    if result is not None \
                            and result.status is Status.OK:
                        if r == via:
                            tr.attempt_end(
                                trace, ctx, statuses.get(r),
                                hedge_outcome=("won" if hedged_race
                                               else None))
                        elif r in statuses:
                            # resolved before the winner: a real
                            # outcome, not a discard
                            tr.attempt_end(trace, ctx, statuses[r])
                        else:
                            # still in flight: its response will be
                            # discarded on arrival — mark now, close
                            # the span AT the discard
                            tr.mark_lost(trace, ctx)
                            pending[r].add_done_callback(
                                lambda f, c=ctx: tr.attempt_end(
                                    trace, c,
                                    (f._result.status.value
                                     if f._result else "abandoned"),
                                    hedge_outcome="lost"))
                    else:
                        tr.attempt_end(trace, ctx,
                                       statuses.get(r, "abandoned"))
            if result is None:
                return ServeResult(
                    Status.DEADLINE_EXCEEDED,
                    error=f"deadline passed waiting on "
                          f"{sorted(pending)}")
            if result.status is Status.OK:
                return result
            if result.status is Status.DEADLINE_EXCEEDED:
                # the budget died at the replica — propagate, don't
                # burn another attempt on a dead budget
                return result
            if result.status in RETRYABLE_STATUSES:
                tried.add(via)
                if hedge_replica is not None:
                    tried.add(hedge_replica)
                last = result
                continue
            return result

    def _drive(self, kind, payload, opts, deadline: Optional[float],
               fut: ServeFuture, t0: float, trace=None,
               model: Optional[str] = None,
               tenant: Optional[str] = None):
        if trace is not None:
            self.tracing.router_queue(trace, t0, self._clock())
        self._resolve(fut, self._attempt_loop(kind, payload, opts,
                                              deadline, trace=trace,
                                              model=model,
                                              tenant=tenant),
                      t0, trace, tenant=tenant)

    def _drive_disagg(self, kind, payload, opts,
                      deadline: Optional[float], fut: ServeFuture,
                      t0: float, trace=None,
                      model: Optional[str] = None,
                      tenant: Optional[str] = None):
        """Disaggregated generate: a prefill dispatch (routed within
        the prefill pool; returns the crc-sealed KV handoff + first
        token) then a decode dispatch (routed within the decode pool)
        under the SAME deadline budget.  The handoff blob is retained
        router-side across decode retries, so a decode replica killed
        mid-stream replays on a survivor within the remaining budget.
        The TraceContext crosses the pool boundary INSIDE the sealed
        blob (handoff extras) as well as on the dispatch itself.
        """
        import numpy as np

        from .pools import deserialize_handoff

        if trace is not None:
            self.tracing.router_queue(trace, t0, self._clock())
        pre = self._attempt_loop("prefill", payload, (), deadline,
                                 trace=trace, model=model,
                                 tenant=tenant)
        if pre.status is not Status.OK:
            self._resolve(fut, pre, t0, trace, tenant=tenant)
            return
        t_hand = self._clock()
        try:
            first = int(deserialize_handoff(pre.output)["first_token"])
        except Exception as e:
            self._resolve(fut, ServeResult(
                Status.INTERNAL_ERROR,
                error=f"prefill handoff unusable: "
                      f"{type(e).__name__}: {e}"), t0, trace,
                tenant=tenant)
            return
        self.metrics.record_ttft(self._clock() - t0, tenant=tenant)
        max_new = opts[0]
        if max_new <= 1:
            self._resolve(fut, ServeResult(
                Status.OK, output=np.asarray([first], np.int32),
                queued_s=pre.queued_s), t0, trace, tenant=tenant)
            return
        if trace is not None:
            # the router-side handoff hop: blob verify + re-dispatch
            self.tracing.handoff(trace, t_hand,
                                 self._clock() - t_hand,
                                 blob_bytes=len(pre.output))
        dec = self._attempt_loop("decode", pre.output, opts, deadline,
                                 trace=trace, model=model,
                                 tenant=tenant)
        if dec.status is not Status.OK:
            self._resolve(fut, dec, t0, trace, tenant=tenant)
            return
        dec.output = np.concatenate(
            [np.asarray([first], np.int32),
             np.asarray(dec.output, np.int32)])
        self._resolve(fut, dec, t0, trace, tenant=tenant)

    # ------------------------------------------------------------ lifecycle
    def close(self, wait: bool = True):
        """Stop accepting new requests and wind down the dispatch
        pool (in-flight drives finish — every accepted request still
        resolves)."""
        self._closed = True
        self._pool.shutdown(wait=wait)
        if self.tracing is not None:
            self.tracing.close()

    def snapshot(self) -> dict:
        with self._lock:
            members = list(self._members)
            inflight = dict(self._inflight)
        return {
            "members": members,
            "live": list(self.live()),
            "degraded": self.degraded,
            "inflight": inflight,
            "registry": (self.model_registry.models()
                         if self.model_registry is not None else None),
            "admission": (self.admission.snapshot()
                          if self.admission is not None else None),
            "pools": {"prefill": list(self.pool_members("prefill")),
                      "decode": list(self.pool_members("decode"))},
            "disaggregate": self.disaggregate,
            "ejections": self.ejections,
            "readmissions": self.readmissions,
            "breakers": {r: b.snapshot()
                         for r, b in sorted(self._breakers.items())},
            "metrics": self.metrics.snapshot(),
            "tracing": (self.tracing.snapshot()
                        if self.tracing is not None else None),
        }
