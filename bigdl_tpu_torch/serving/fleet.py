"""Replica fleet: membership, health publishing, rolling verified deploys
(counterpart of ``bigdl_tpu/serving/fleet.py``).

This is the integration layer the ROADMAP's planet-scale-serving item
asks for: N hardened :class:`~.server.InferenceServer` replicas become
ONE serving surface with the same fault story training got in the
robustness arc.

* :class:`ReplicaAgent` — one per replica: heartbeats + a health
  snapshot (``ready``, queue depth, breaker state, p99) published
  through the **elastic KV transport**
  (:class:`~bigdl_tpu_torch.resilience.elastic.ElasticCoordinator` — the
  identical membership protocol training gangs run, incarnation
  numbers included).  The agent is also the fleet chaos surface:
  :func:`~bigdl_tpu_torch.resilience.faults.kill_replica` hard-stops its
  server at the next pump, :func:`~bigdl_tpu_torch.resilience.faults
  .partition_kv` silences its publishing.
* :class:`~.router.FleetRouter` — maintained by the fleet's pump
  loop: health-aware least-loaded dispatch, deadline-budget failover
  retries, optional p99-derived hedging, per-replica breakers, and
  membership ejection/re-admission.
* **Rolling verified deploys** — :meth:`ServingFleet.rolling_swap`
  rolls new params through the fleet ONE replica at a time, each
  through the existing crc32c-verified load + canary
  (:meth:`~.server.InferenceServer.swap_params`).  The first
  :class:`~.swap.SwapRejected` halts the deploy and rolls every
  already-swapped replica back to its prior params, and the deploy
  never proceeds while the rest of the fleet is below the configured
  **ready quorum** — a poisoned artifact can never serve a user
  request, fleet-wide.

The fleet's merged telemetry rides the existing cross-host fold
(:func:`~bigdl_tpu_torch.telemetry.aggregate.merge_metrics`): per-replica
registries sum into one cluster view, ``write_snapshots`` drops the
per-replica payloads the run report (``telemetry.report``) renders, and
:meth:`goodput_per_chip` reports served model-FLOP/s per chip — the
serving analogue of cluster MFU.

Replicas share a device, never their parameters.  The port's
:meth:`~.server.InferenceServer.swap_params` copies a candidate into
its server's model in place, so :meth:`ServingFleet.build` and
:meth:`ServingFleet.build_multi` give every replica its own copy of the
model (``clone_module``): a rolling swap, a rollback or a training step
on the caller's model never writes a tensor another replica reads.
Servers passed in by hand must not share one model object.
"""
from __future__ import annotations

import json
import logging
import threading
import time
from typing import Callable, Dict, Optional

from ..resilience import faults as _faults
from ..resilience.elastic import ElasticCoordinator, InMemoryKV
from ..telemetry.events import record_change as _record_change
from .metrics import ServingMetrics
from .router import FleetRouter, HEALTH_PREFIX
from .server import InferenceServer
from .swap import DeployInFlight, SwapRejected, load_verified_params

log = logging.getLogger("bigdl_tpu")


class FleetQuorumError(RuntimeError):
    """A rolling deploy (or other fleet-wide operation) would drop the
    ready replica count below the configured quorum — refused."""


class ReplicaAgent:
    """The publisher side of fleet membership for ONE replica.

    ``pump()`` — called by the fleet's heartbeat loop (or directly by
    tests) — consults the fleet fault injectors, acks any new
    incarnation, heartbeats through the coordinator, and publishes the
    health snapshot the router routes on.  A killed agent stays
    silent; a partitioned one stays alive but invisible.
    """

    def __init__(self, replica_id: str, server: InferenceServer,
                 transport, heartbeat_timeout: float = 2.0,
                 clock: Callable[[], float] = time.monotonic):
        self.replica_id = str(replica_id)
        self.server = server
        self.coordinator = ElasticCoordinator(
            self.replica_id, transport,
            heartbeat_timeout=heartbeat_timeout, clock=clock)
        self._clock = clock
        self._beats = 0
        self._acked: Optional[int] = None
        self.killed = False

    def health_snapshot(self) -> dict:
        h = self.server.health()
        m = self.server.metrics
        snap = {
            "replica": self.replica_id,
            "ready": h["ready"],
            "healthy": h["healthy"],
            "draining": h["draining"],
            "queue_depth": h["queue_depth"],
            "breaker_state": h["breaker"]["state"],
            "role": h.get("role", "both"),
            # multi-tenant fleets: which (model, version) this replica
            # advertises — the router routes model-addressed requests
            # over the advertising subset only
            "model": h.get("model"),
            "model_version": h.get("model_version"),
            "p99_s": m._lat.quantile(0.99),
            "served_ok": int(m.counts["ok"]),
            # shed/total ride along so the autoscaler can derive a
            # per-pool shed RATE from published signals alone
            "shed_total": int(m.counts["overloaded"]),
            "requests_total": int(sum(m.counts.values())),
            "ts": self._clock(),
        }
        kv = h.get("kv")
        if kv:
            snap["kv_occupancy"] = kv["occupancy"]
            snap["kv_free_pages"] = kv["free_pages"]
            snap["kv_pages"] = kv["num_pages"]
            # keep the replica's pool gauges fresh at heartbeat cadence
            m.set_kv_pool(kv)
        return snap

    def pump(self):
        """One heartbeat round.  No-op once killed; silent while
        partitioned (beats age out and the router presumes us dead —
        exactly a dead training host's signature)."""
        if self.killed:
            return
        fault = _faults.check_fleet_fault(self.replica_id)
        if fault == "kill":
            self.kill()
            return
        if fault == "partition":
            return
        c = self.coordinator
        n, members = c.membership()
        if n != self._acked:
            c.ack(n)
            self._acked = n
        self._beats += 1
        # a healed partition (or an ejected replica coming back) beats
        # with rejoin=True until the membership includes it again
        c.heartbeat(step=self._beats,
                    rejoin=self.replica_id not in members)
        snap = self.health_snapshot()
        snap["incarnation"] = n
        c.transport.put(HEALTH_PREFIX + self.replica_id,
                        json.dumps(snap))

    def kill(self):
        """Injected replica death: hard-stop the server (queued
        requests resolve CANCELLED — typed, never silent) and stop
        heartbeating."""
        self.killed = True
        log.warning("fleet: replica %s killed", self.replica_id)
        self.server.stop(timeout=0.5)


class ServingFleet:
    """N replicas + agents + router behind one lifecycle.

    Build one either from pre-constructed servers
    (``ServingFleet(servers={...})``) or with :meth:`build`, which
    stamps out ``n_replicas`` named servers over one model.  ``start``
    launches every server, runs one synchronous pump round (so the
    router has a live view before the first request), then starts the
    background pump thread.
    """

    def __init__(self, servers: Dict[str, InferenceServer],
                 transport=None, *, heartbeat_timeout: float = 2.0,
                 pump_interval_s: Optional[float] = None,
                 ready_quorum: Optional[int] = None,
                 router_kw: Optional[dict] = None,
                 tracing: bool = False,
                 trace_kw: Optional[dict] = None,
                 health: bool = False,
                 health_kw: Optional[dict] = None,
                 clock: Callable[[], float] = time.monotonic):
        if not servers:
            raise ValueError("a fleet needs at least one replica")
        self.transport = transport if transport is not None \
            else InMemoryKV()
        self.servers = dict(servers)
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.pump_interval_s = (heartbeat_timeout / 4.0
                                if pump_interval_s is None
                                else float(pump_interval_s))
        # quorum default: strict majority of the configured fleet
        self.ready_quorum = (len(self.servers) // 2 + 1
                             if ready_quorum is None
                             else int(ready_quorum))
        self._clock = clock
        self.agents = {
            rid: ReplicaAgent(rid, srv, self.transport,
                              heartbeat_timeout=heartbeat_timeout,
                              clock=clock)
            for rid, srv in self.servers.items()}
        coordinator = ElasticCoordinator(
            "fleet-router", self.transport,
            heartbeat_timeout=heartbeat_timeout, clock=clock)
        coordinator.bootstrap(sorted(self.servers))
        router_kw = dict(router_kw or {})
        router_kw.setdefault("clock", clock)
        # distributed request tracing: one router-side RequestTracer
        # (context minting, tail sampling, stitching) + one
        # ReplicaTraceSink bound into every replica, publishing
        # fragments under trc/<incarnation>/<trace_id>/<host> on the
        # SAME KV transport membership rides
        if tracing and "tracing" not in router_kw:
            from ..telemetry.trace_context import TailSampler
            from .request_trace import RequestTracer

            trace_kw = dict(trace_kw or {})
            sampler = trace_kw.pop("sampler", None) or TailSampler(
                **{k: trace_kw.pop(k) for k in
                   ("keep_per_s", "burst", "ok_prob")
                   if k in trace_kw})
            tracer = RequestTracer(
                transport=self.transport,
                incarnation_of=lambda c=coordinator: c.membership()[0],
                sampler=sampler, clock=clock, **trace_kw)
            # publish-on-keep: replica fragments stay buffered until
            # the router's TAIL decision keeps the trace — dropped
            # traces never touch the transport (the <=3% overhead
            # budget), errors/hedges/retries always publish
            tracer.on_keep = self._publish_kept_trace
            router_kw["tracing"] = tracer
            for rid, srv in self.servers.items():
                if srv.trace_sink is None:
                    srv.trace_sink = self._make_sink(rid)
        self.router = FleetRouter(self.servers, coordinator,
                                  **router_kw)
        # per-replica SLO health (serving/health.py): each pump round
        # evaluates the per-replica rule pack over published health
        # and marks breaching replicas degraded on the router —
        # answering-but-answering-badly replicas leave rotation
        # through the same eject machinery silence does
        self.health_monitor = None
        if health:
            from .health import FleetHealthMonitor

            self.health_monitor = FleetHealthMonitor(
                self, clock=clock, **(health_kw or {}))
        self.deploys = 0
        self.deploy_rollbacks = 0
        # deploy-in-flight mutual exclusion, PER REPLICA: a roll
        # acquires (non-blocking, sorted — no deadlock) the lock of
        # every replica it will touch, so two model-scoped deploys on
        # disjoint replica sets proceed concurrently while any overlap
        # — including two fleet-wide rolls — is refused typed
        # (DeployInFlight), never queued, before any replica is touched
        self._deploy_table_lock = threading.Lock()
        self._deploy_locks: Dict[str, threading.Lock] = {}
        # the last completed roll per deploy scope (model name, or
        # None for a fleet-wide roll): [(rid, prior, prior_version)]
        # — what an alert-driven rollback_last_deploy() re-installs
        self._last_deploy: Dict[Optional[str], list] = {}
        self._pump_thread: Optional[threading.Thread] = None
        self._stop_pump = threading.Event()

    def _make_sink(self, rid: str):
        """One replica's trace sink, incarnation-stamped by its agent
        (fragments published under a dead membership still stitch —
        the reader scans across incarnations).  Lazy publishing: the
        router's keep decision pulls the fragment."""
        from .request_trace import ReplicaTraceSink

        agent = self.agents.get(rid)
        return ReplicaTraceSink(
            rid, transport=self.transport,
            incarnation_of=(lambda a=agent: (a._acked or 0))
            if agent is not None else None,
            eager_publish=False, clock=self._clock)

    def _publish_kept_trace(self, trace_id: str):
        for srv in list(self.servers.values()):
            sink = getattr(srv, "trace_sink", None)
            if sink is not None:
                sink.publish_trace(trace_id)

    @property
    def tracing(self):
        """The router-side RequestTracer (None when tracing is off)."""
        return self.router.tracing

    def kept_traces(self):
        return self.router.tracing.kept_traces() \
            if self.router.tracing is not None else []

    def stitch_trace(self, trace_id: str, skew=None):
        """One kept request's cross-replica Perfetto timeline (replica
        sinks flushed first so freshly resolved fragments are
        visible)."""
        if self.router.tracing is None:
            return None
        sinks = [srv.trace_sink for srv in self.servers.values()
                 if getattr(srv, "trace_sink", None) is not None]
        return self.router.tracing.stitch(trace_id, skew=skew,
                                          flush_sinks=sinks)

    @classmethod
    def build(cls, model, n_replicas: int = 4, transport=None,
              server_kw: Optional[dict] = None, roles=None,
              kv_pages: Optional[int] = None, kv_page_size: int = 16,
              **fleet_kw) -> "ServingFleet":
        """Stamp out ``n_replicas`` named servers (``r0``…) over one
        model.  Each replica serves its own copy of ``model`` (see the
        module docstring), so a per-replica swap/rollback never bleeds
        across replicas.

        ``roles`` (a sequence per index or dict per replica id) builds
        a disaggregated fleet — e.g. ``roles=("prefill", "decode",
        "decode")``; ``kv_pages`` gives every replica its OWN
        ``kv_page_size``-paged KV pool (required for non-``both``
        roles; with role ``both`` it switches generation to the paged
        path)."""
        servers = {}
        for i in range(int(n_replicas)):
            rid = f"r{i}"
            kw = dict(server_kw or {})
            if roles is not None:
                kw["role"] = roles[rid] if isinstance(roles, dict) \
                    else roles[i]
            replica_model = model.clone_module()
            if kv_pages:
                from .kvpool import KVPagePool

                kw["kv_pool"] = KVPagePool.for_model(
                    replica_model, kv_pages, page_size=kv_page_size)
            servers[rid] = InferenceServer(replica_model, name=rid, **kw)
        return cls(servers, transport, **fleet_kw)

    @classmethod
    def build_multi(cls, models: Dict[str, object],
                    n_replicas_each: int = 2, transport=None,
                    server_kw: Optional[dict] = None,
                    versions: Optional[Dict[str, str]] = None,
                    quotas: Optional[Dict[str, float]] = None,
                    admission_capacity: Optional[int] = None,
                    deadline_budgets: Optional[Dict[str, float]] = None,
                    kv_pages: Optional[int] = None,
                    kv_page_size: int = 16,
                    **fleet_kw) -> "ServingFleet":
        """Stamp out a multi-tenant fleet: ``n_replicas_each`` replicas
        per model (named ``<model>-r<i>``), each advertising its
        (model, version) through the health snapshot the router routes
        on, behind one pre-wired
        :class:`~.registry.ModelRegistry` and
        :class:`~.registry.AdmissionController`.

        ``quotas`` are per-tenant admission weights (default: equal
        weight per model), ``admission_capacity`` the fleet-wide
        inflight ceiling the weights slice (default: 4 × replicas),
        ``deadline_budgets`` optional per-tenant deadline ceilings.
        ``kv_pages`` gives every replica its own paged pool whose
        ``default_owner`` is the replica's model, so decoder-internal
        page allocations are charged to the right tenant."""
        from .registry import AdmissionController, ModelRegistry

        registry = ModelRegistry()
        servers: Dict[str, InferenceServer] = {}
        for model_name in sorted(models):
            model = models[model_name]
            version = (versions or {}).get(model_name, "v1")
            registry.register(model_name, version)
            for i in range(int(n_replicas_each)):
                rid = f"{model_name}-r{i}"
                kw = dict(server_kw or {})
                replica_model = model.clone_module()
                if kv_pages:
                    from .kvpool import KVPagePool

                    kw["kv_pool"] = KVPagePool.for_model(
                        replica_model, kv_pages, page_size=kv_page_size)
                servers[rid] = InferenceServer(
                    replica_model, name=rid, model_name=model_name,
                    model_version=version, **kw)
        admission = AdmissionController(
            admission_capacity if admission_capacity is not None
            else 4 * len(servers),
            quotas=quotas if quotas is not None
            else {m: 1.0 for m in models},
            deadline_budgets=deadline_budgets)
        router_kw = dict(fleet_kw.pop("router_kw", None) or {})
        router_kw.setdefault("model_registry", registry)
        router_kw.setdefault("admission", admission)
        return cls(servers, transport, router_kw=router_kw, **fleet_kw)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ServingFleet":
        for srv in self.servers.values():
            if not srv.healthy():
                srv.start()
        self.pump_once()
        if self.pump_interval_s > 0:
            self._stop_pump.clear()
            self._pump_thread = threading.Thread(
                target=self._pump_loop, daemon=True,
                name="bigdl-fleet-pump")
            self._pump_thread.start()
        return self

    def pump_once(self):
        """One synchronous membership round: every agent beats, then
        the router refreshes its view.  Tests drive this directly for
        deterministic membership transitions."""
        for agent in list(self.agents.values()):
            agent.pump()
        if self.health_monitor is not None:
            # evaluate BEFORE the refresh so a fresh degradation mark
            # is acted on (ejected) in this same round
            self.health_monitor.observe()
        self.router.refresh()

    def _pump_loop(self):
        while not self._stop_pump.wait(self.pump_interval_s):
            try:
                self.pump_once()
            except Exception:
                log.exception("fleet: pump round failed")

    def stop(self, timeout: Optional[float] = 10.0) -> bool:
        """Stop the pump, close the router (in-flight requests still
        resolve), and hard-stop every replica."""
        self._stop_pump.set()
        if self._pump_thread is not None:
            self._pump_thread.join(timeout)
            self._pump_thread = None
        self.router.close()
        ok = True
        for srv in list(self.servers.values()):
            ok = srv.stop(timeout=timeout) and ok
            sink = getattr(srv, "trace_sink", None)
            if sink is not None:
                sink.close()
        return ok

    # ------------------------------------------------------------ routing
    def submit(self, feature, deadline_s=None, **kw):
        return self.router.submit(feature, deadline_s=deadline_s, **kw)

    def submit_generate(self, prompt_ids, max_new, **kw):
        return self.router.submit_generate(prompt_ids, max_new, **kw)

    def ready_count(self, exclude=()) -> int:
        return sum(1 for rid, srv in self.servers.items()
                   if rid not in exclude and srv.ready())

    def pool_replicas(self, role: str) -> Dict[str, InferenceServer]:
        """Servers whose advertised role serves ``role`` (``both``
        members serve every pool)."""
        from .pools import serves_phase

        return {rid: srv for rid, srv in self.servers.items()
                if serves_phase(getattr(srv, "role", "both"), role)}

    # ------------------------------------------------------- elasticity
    def add_replica(self, rid: str,
                    server: InferenceServer) -> InferenceServer:
        """Join one new replica to the running fleet (the autoscaler's
        scale-up actuator): start it, give it an agent, register it
        with the router, and run one pump round so it is routable
        before this returns."""
        if rid in self.servers:
            raise ValueError(f"replica {rid!r} already in the fleet")
        self.servers[rid] = server
        if not server.healthy():
            server.start()
        agent = ReplicaAgent(rid, server, self.transport,
                             heartbeat_timeout=self.heartbeat_timeout,
                             clock=self._clock)
        self.agents[rid] = agent
        if self.router.tracing is not None \
                and server.trace_sink is None:
            server.trace_sink = self._make_sink(rid)
        self.router.add_replica(rid, server)
        agent.pump()            # beats with rejoin=True
        self.router.refresh()   # ... and is re-admitted here
        _record_change("replica_added",
                       f"role={getattr(server, 'role', 'both')}",
                       source="serving.fleet", replica=rid,
                       model=getattr(server, "model_name", None))
        log.info("fleet: added replica %s (role=%s)", rid,
                 getattr(server, "role", "both"))
        return server

    def remove_replica(self, rid: str, timeout: float = 10.0,
                       drain: bool = True) -> bool:
        """Retire one replica (the autoscaler's scale-down actuator):
        **drain before retire** — admission stops via the graceful-
        preemption path and everything already admitted finishes
        (in-flight paged decodes resolve and release their pages) —
        then hard-stop, deregister from the router, and retire from
        membership immediately.  Returns True when the worker exited
        within ``timeout``."""
        srv = self.servers.pop(rid, None)
        if srv is None:
            return False
        self.agents.pop(rid, None)     # stops heartbeating this rid
        ok = True
        if drain and srv.healthy():
            ok = srv.drain(timeout)
        ok = srv.stop(timeout) and ok
        self.router.remove_replica(rid)
        _record_change("replica_removed", f"drained={drain}",
                       source="serving.fleet", replica=rid,
                       model=getattr(srv, "model_name", None))
        log.info("fleet: removed replica %s (drained=%s)", rid, drain)
        return ok

    def restart_replica(self, rid: str) -> InferenceServer:
        """Revive a killed or stopped replica in place (crash
        replacement): restart its server, clear the agent's killed
        latch, and run one pump round so it beats with ``rejoin=True``
        and re-admits through the normal returner path."""
        srv = self.servers[rid]
        agent = self.agents[rid]
        if not srv.healthy():
            srv.start()
        agent.killed = False
        agent.pump()
        self.router.refresh()
        _record_change("replica_restarted", source="serving.fleet",
                       replica=rid,
                       model=getattr(srv, "model_name", None))
        log.info("fleet: restarted replica %s", rid)
        return srv

    # ------------------------------------------------------------ deploys
    def _acquire_deploy_locks(self, rids):
        """Non-blocking, sorted acquisition of the per-replica deploy
        locks for ``rids``.  Any lock already held means another
        deploy/rollback is touching an overlapping replica set —
        everything taken so far is released and the whole operation is
        refused typed (:class:`~.swap.DeployInFlight`) before any
        replica is touched.  Sorted order keeps two overlapping
        acquisitions deadlock-free."""
        acquired = []
        for rid in sorted(set(rids)):
            with self._deploy_table_lock:
                lk = self._deploy_locks.setdefault(
                    rid, threading.Lock())
            if not lk.acquire(blocking=False):
                for got in reversed(acquired):
                    got.release()
                raise DeployInFlight(
                    f"a deploy is already in flight on replica {rid} "
                    f"— refused before touching any replica")
            acquired.append(lk)
        return acquired

    def rolling_swap(self, params=None, path: Optional[str] = None,
                     order=None, model: Optional[str] = None,
                     version: Optional[str] = None) -> int:
        """Verified deploy, one replica at a time.

        ``model`` scopes the roll to the replicas serving that model
        (a tenant-scoped deploy on a multi-tenant fleet — replicas of
        other models are never locked, never touched); ``model=None``
        rolls the whole fleet.  ``version`` stamps the installed
        params' advertised model version (health snapshots and the
        model registry pick it up), and a rollback re-installs the
        prior version alongside the prior params.

        ``path`` loads ONCE through the crc32c-verified checkpoint
        path (corrupt bytes refuse the whole deploy before any replica
        is touched).  Each replica then runs its own canary via
        :meth:`~.server.InferenceServer.swap_params`; the first
        :class:`SwapRejected` halts the roll and **rolls back every
        already-swapped replica** to its captured prior params.
        Before each replica swaps, the deploy scope must hold its
        ready quorum (fleet-wide: ``ready_quorum``; model-scoped: a
        strict majority of that model's replicas) — otherwise
        :class:`FleetQuorumError` (and rollback of anything already
        swapped).  Returns the number of replicas deployed.

        Replicas that are not healthy (killed, draining) are skipped —
        they pick up current params through the normal swap path when
        they come back.

        Mutual exclusion is per replica: a concurrent deploy/rollback
        touching ANY overlapping replica raises
        :class:`~.swap.DeployInFlight` immediately, before any replica
        is touched, while deploys on disjoint models proceed
        concurrently.
        """
        if (params is None) == (path is None):
            raise ValueError("pass exactly one of params/path")
        if model is not None:
            targets = sorted(
                rid for rid, srv in self.servers.items()
                if getattr(srv, "model_name", None) == model)
            if not targets:
                raise ValueError(
                    f"no replica serves model {model!r}")
        else:
            targets = sorted(self.servers)
        if order is not None:
            known = set(targets)
            order = [rid for rid in order if rid in known]
        else:
            order = targets
        locks = self._acquire_deploy_locks(targets)
        try:
            if path is not None:
                params = load_verified_params(path)
            _record_change(
                "deploy_started",
                f"version={version} targets={len(targets)}",
                source="serving.fleet", model=model)
            quorum = (self.ready_quorum if model is None
                      else len(targets) // 2 + 1)
            done = []  # [(rid, (prior_params, prior_bufs), prior_ver)]
            for rid in order:
                srv = self.servers.get(rid)
                if srv is None or not srv.healthy():
                    log.warning("fleet: deploy skipping unhealthy "
                                "replica %s", rid)
                    continue
                ready = (self.ready_count() if model is None else
                         sum(1 for r in targets
                             if self.servers[r].ready()))
                if ready < quorum:
                    self._rollback(done)
                    self.deploy_rollbacks += 1
                    _record_change(
                        "deploy_rolled_back",
                        f"quorum lost before {rid}",
                        source="serving.fleet", model=model)
                    raise FleetQuorumError(
                        f"deploy halted before {rid}: only {ready} "
                        f"replica(s) ready, quorum is {quorum} — "
                        f"rolled back")
                prior = srv.current_params()
                prior_version = getattr(srv, "model_version", None)
                try:
                    srv.swap_params(params=params, version=version)
                except SwapRejected as e:
                    self._rollback(done)
                    self.deploy_rollbacks += 1
                    _record_change(
                        "deploy_rolled_back",
                        f"canary rejected at {rid}",
                        source="serving.fleet", replica=rid,
                        model=model)
                    raise SwapRejected(
                        f"rolling deploy halted at {rid}: {e} — "
                        f"{len(done)} already-swapped replica(s) "
                        f"rolled back")
                done.append((rid, prior, prior_version))
                log.info("fleet: deployed to %s (%d/%d)", rid,
                         len(done), len(order))
            self.deploys += 1
            _record_change(
                "deploy_confirmed",
                f"version={version} replicas={len(done)}",
                source="serving.fleet", model=model)
            with self._deploy_table_lock:
                self._last_deploy[model] = done
            if (model is not None and version is not None
                    and self.router.model_registry is not None):
                # advertise the new version fleet-wide (per-replica
                # health snapshots catch up at the next pump)
                self.router.model_registry.register(model, version)
            return len(done)
        finally:
            for lk in reversed(locks):
                lk.release()

    def rollback_last_deploy(self, model: Optional[str] = None) -> int:
        """Roll every replica of the last completed deploy (for
        ``model``'s scope; ``None`` = the last fleet-wide roll) back
        to its captured prior params — the alert-driven entry point
        the continuous-learning loop fires when the post-swap
        burn-rate watch trips.  The rollback rides the same verified
        canary install path as a deploy (each re-install records
        ``outcome="rolled_back"``), holds the same per-replica deploy
        locks, and consumes the captured set: a second call with
        nothing newer deployed is a no-op returning 0."""
        with self._deploy_table_lock:
            pending = list(self._last_deploy.get(model, ()))
        if not pending:
            return 0
        locks = self._acquire_deploy_locks(e[0] for e in pending)
        try:
            with self._deploy_table_lock:
                done = self._last_deploy.pop(model, [])
            if not done:
                return 0
            self._rollback(done)
            self.deploy_rollbacks += 1
            _record_change(
                "deploy_rolled_back",
                f"alert-driven rollback of {len(done)} replica(s)",
                source="serving.fleet", model=model)
            if (model is not None
                    and self.router.model_registry is not None
                    and done[0][2] is not None):
                # re-advertise the prior version alongside the prior
                # params
                self.router.model_registry.register(model, done[0][2])
            log.warning("fleet: alert-driven rollback re-installed "
                        "prior params on %d replica(s)", len(done))
            return len(done)
        finally:
            for lk in reversed(locks):
                lk.release()

    def _rollback(self, done):
        for rid, (prior_params, prior_buffers), prior_version \
                in reversed(done):
            try:
                # the rollback rides the full verified install path
                # (canary included) — only its counter outcome differs
                self.servers[rid].swap_params(params=prior_params,
                                              buffers=prior_buffers,
                                              version=prior_version,
                                              outcome="rolled_back")
            except SwapRejected:
                # the prior params were serving seconds ago; a canary
                # refusing them now means something else is injecting
                # failures — keep rolling back the rest, loudly
                log.exception("fleet: rollback canary failed on %s",
                              rid)

    # ------------------------------------------------------------ telemetry
    def goodput_per_chip(self) -> dict:
        """Served model-FLOP/s per chip over the fleet's first→last
        batch window, and that rate as a fraction of one chip's peak —
        one replica is counted as one chip, as in the JAX package
        (replicas that share one card divide its rate among them)."""
        total = 0.0
        t0 = t1 = None
        for srv in self.servers.values():
            g = srv.metrics.goodput_per_chip()
            total += g["flops_total"]
            w0, w1 = srv.metrics.batch_window()
            if w0 is not None:
                t0 = w0 if t0 is None else min(t0, w0)
                t1 = w1 if t1 is None else max(t1, w1)
        chips = max(1, len(self.servers))
        wall = (t1 - t0) if (t0 is not None and t1 is not None) else 0.0
        rate = total / wall / chips if wall > 0 else 0.0
        out = {"flops_total": total, "wall_s": wall, "chips": chips,
               "model_flops_per_sec_per_chip": rate, "mfu": None}
        if rate > 0:
            try:
                from ..telemetry.device_info import current_device_spec

                spec = current_device_spec(next(
                    iter(self.servers.values())).device)
                if spec.peak_flops_per_sec:
                    out["mfu"] = rate / spec.peak_flops_per_sec
                    out["nominal_device"] = spec.nominal
            except Exception:
                pass
        return out

    #: router registry families folded into the fleet view — the ones
    #: only the router populates.  Its *request* families share names
    #: with the replicas' (it records fleet-level outcomes, they
    #: record per-attempt outcomes); folding both would double-count,
    #: so the router's copies of shared names stay in its own
    #: ``router`` section.
    _ROUTER_FOLD_FAMILIES = (
        "bigdl_serving_hedges_total", "bigdl_serving_retries_total",
        "bigdl_fleet_dispatch_total",
        "bigdl_autoscale_decisions_total",
        "bigdl_alerts_total", "bigdl_alerts_active",
        # the continuous-learning loop registers its deploy outcomes
        # in the router registry, so they fold into the fleet view too
        "bigdl_loop_deploys_total",
        # multi-tenant families only the router populates (admission
        # decisions, per-tenant dispatch, inflight gauge, typed sheds)
        "bigdl_tenant_dispatch_total", "bigdl_tenant_admission_total",
        "bigdl_tenant_inflight", "bigdl_tenant_sheds_total",
    )

    def _router_fold_metrics(self) -> dict:
        snap = self.router.metrics.registry.snapshot()["metrics"]
        return {name: fam for name, fam in snap.items()
                if name in self._ROUTER_FOLD_FAMILIES}

    def snapshot(self) -> dict:
        """The fleet view: per-replica snapshots, the router's, the
        membership state, fleet goodput-per-chip, and the per-replica
        metric registries folded into one cluster view by the existing
        cross-host merge (:func:`telemetry.aggregate.merge_metrics` —
        counters sum, histogram buckets add)."""
        from ..telemetry.aggregate import merge_metrics

        per_replica = {rid: srv.metrics.snapshot()
                       for rid, srv in sorted(self.servers.items())}
        registries = [srv.metrics.registry.snapshot()["metrics"]
                      for _, srv in sorted(self.servers.items())]
        registries.append(self._router_fold_metrics())
        n, members = self.router.coordinator.membership()
        return {
            "replicas": per_replica,
            "router": self.router.snapshot(),
            "membership": {
                "incarnation": n,
                "members": list(members),
                "ejections": self.router.ejections,
                "readmissions": self.router.readmissions,
            },
            "deploys": self.deploys,
            "deploy_rollbacks": self.deploy_rollbacks,
            # per-tenant request/shed fold (router-side attribution —
            # one row per tenant, empty dict on single-model fleets)
            "tenants": self.router.metrics.tenants(),
            "goodput_per_chip": self.goodput_per_chip(),
            "health": (self.health_monitor.snapshot()
                       if self.health_monitor is not None else None),
            "metrics": merge_metrics(registries),
        }

    def to_prometheus(self) -> str:
        """Prometheus text of every replica registry plus the
        router's, each series labeled — scrape-ready fleet view."""
        parts = [srv.metrics.to_prometheus()
                 for _, srv in sorted(self.servers.items())]
        parts.append(self.router.metrics.to_prometheus())
        return "\n".join(parts)

    def write_snapshots(self, directory: str) -> list:
        """Drop one ``<replica>.json`` payload per replica (plus the
        router's) into ``directory`` — the snapshot-dir format
        the run report (``telemetry.report``) merges and renders."""
        from ..telemetry.aggregate import write_snapshot

        n, _ = self.router.coordinator.membership()
        paths = []
        for rid, srv in sorted(self.servers.items()):
            serving = srv.metrics.snapshot()
            # the router's tenants map is the authoritative per-tenant
            # accounting (it sees every request, including sheds that
            # never reach a replica); the replicas' copies would
            # double-count against it in the merge
            serving.pop("tenants", None)
            payload = {
                "host": rid,
                "incarnation": n,
                "metrics": srv.metrics.registry.snapshot()["metrics"],
                "serving": serving,
            }
            paths.append(write_snapshot(directory, rid, payload))
        paths.append(write_snapshot(directory, "fleet-router", {
            "host": "fleet-router",
            "incarnation": n,
            # only the router-specific families (hedges/retries/
            # dispatch): its copies of the shared request families
            # would double-count against the replicas' in the merge
            "metrics": self._router_fold_metrics(),
            "serving": self.router.metrics.snapshot(),
        }))
        return paths
