"""Fleet-wide change journal: the typed, ordered record of every
state-changing act any subsystem performs.

The observability stack can *detect* degradation (the SLO engine's
burn-rate/anomaly alerts) and *measure* where latency lives (critical-
path traces); what it could not answer before this module is "what
CHANGED?" — deploys, rollbacks, membership evictions, autoscale moves,
breaker trips, registry flips, tenant-quota sheds and chaos injections
were scattered across per-subsystem logs.  The
:class:`ChangeJournal` is the one bounded, ordered ring they all emit
into, and the :class:`~.incidents.IncidentEngine` reads it back to
align "metric went bad at T" with "something changed at T-ε".

Every event is a :class:`ChangeEvent`:

* ``kind``     — a short verb from the event vocabulary
  (``deploy_started``, ``membership_evict``, ``autoscale_up``,
  ``breaker_open``, ``tenant_shed``, ``chaos_inject``, ...);
* ``at``       — journal-clock time (``time.monotonic`` by default, so
  event times are directly comparable with
  :class:`~.timeseries.MetricRecorder` sample times);
* ``scope``    — the blast radius as labels: any of
  ``host`` / ``replica`` / ``pool`` / ``model`` / ``tenant`` /
  ``table``.  An empty scope means fleet-wide.  Scope is what lets
  attribution rank an event touching the breached series' replica
  above one touching the whole fleet;
* ``ground_truth`` — ``True`` only when a chaos injector
  (:mod:`bigdl_tpu_torch.resilience.faults`) recorded the event at arm time.
  Benches score blame rankings against these; production code never
  sets it.

Journal writes are lock-cheap (one deque append + one counter inc) —
safe on pump/dispatch paths.  High-rate sites (per-request tenant
sheds) use :meth:`ChangeJournal.record_throttled` so a flood cannot
evict the deploy event that explains it out of the bounded ring.

A process-wide default journal mirrors the ``default_registry``
pattern: subsystems call :func:`record_change` unconditionally, tests
isolate with :func:`reset_default_journal`.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from . import metric_names as M
from .registry import default_registry

__all__ = [
    "CHANGE_EVENT_KINDS", "ChangeEvent", "ChangeJournal",
    "default_journal", "record_change", "reset_default_journal",
]

#: scope keys an event may carry (anything else is dropped at record
#: time — the vocabulary stays closed so attribution can match scopes
#: against SLO rule labels without guessing)
SCOPE_KEYS = ("host", "replica", "pool", "model", "tenant", "table")

#: the event vocabulary — every ``kind`` any subsystem records.  Like
#: the metric-name table this is NAMES only; emitting an unlisted kind
#: raises, so the vocabulary cannot drift silently.
CHANGE_EVENT_KINDS = frozenset({
    # deploys (serving/fleet.py, serving/swap.py, loop/continuous.py)
    "deploy_started", "deploy_confirmed", "deploy_rejected",
    "deploy_rolled_back",
    # fleet elasticity (serving/fleet.py)
    "replica_added", "replica_removed", "replica_restarted",
    # cluster membership (resilience/elastic.py)
    "membership_change", "membership_evict", "membership_readmit",
    # autoscaler verdicts (serving/autoscale.py)
    "autoscale_up", "autoscale_down",
    # circuit breaker transitions (serving/breaker.py)
    "breaker_open", "breaker_half_open", "breaker_closed",
    # model registry flips (serving/registry.py)
    "model_registered", "model_unregistered",
    # admission control (serving/router.py)
    "tenant_shed",
    # chaos injections (resilience/faults.py, ground_truth=True)
    "chaos_inject", "chaos_clear",
})


@dataclass(frozen=True)
class ChangeEvent:
    """One recorded state change — see the module docstring."""
    seq: int
    kind: str
    at: float
    scope: Dict[str, str] = field(default_factory=dict)
    detail: str = ""
    ground_truth: bool = False
    source: str = ""

    def to_dict(self) -> dict:
        return {"seq": self.seq, "kind": self.kind,
                "at": round(self.at, 6), "scope": dict(self.scope),
                "detail": self.detail,
                "ground_truth": self.ground_truth,
                "source": self.source}


class ChangeJournal:
    """Bounded, ordered, thread-safe ring of :class:`ChangeEvent`.

    ``clock`` defaults to ``time.monotonic`` so event times share the
    :class:`~.timeseries.MetricRecorder` timebase; benches inject a
    fake clock into both for deterministic alignment.
    """

    def __init__(self, capacity: int = 2048,
                 clock: Optional[Callable[[], float]] = None,
                 registry=None):
        self.capacity = max(1, int(capacity))
        self._clock = clock or time.monotonic
        self._events: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._next_seq = 0
        #: (kind, throttle-key) -> last record time
        self._throttle: Dict[tuple, float] = {}
        self._counter = (registry if registry is not None
                         else default_registry()).counter(
            M.CHANGE_EVENTS_TOTAL,
            "state-change events recorded into the change journal",
            labels=("kind",))
        self.dropped = 0   # throttled (never recorded) events

    # ------------------------------------------------------------ write
    def record(self, kind: str, detail: str = "", *,
               ground_truth: bool = False, source: str = "",
               now: Optional[float] = None,
               **scope) -> ChangeEvent:
        """Append one event.  ``scope`` keyword args are restricted to
        :data:`SCOPE_KEYS`; ``None`` values are dropped so call sites
        can pass optional model/tenant straight through."""
        if kind not in CHANGE_EVENT_KINDS:
            raise ValueError(
                f"unknown change-event kind {kind!r} — add it to "
                f"telemetry.events.CHANGE_EVENT_KINDS first")
        clean = {k: str(v) for k, v in scope.items()
                 if k in SCOPE_KEYS and v is not None}
        at = self._clock() if now is None else float(now)
        with self._lock:
            ev = ChangeEvent(seq=self._next_seq, kind=kind, at=at,
                             scope=clean, detail=str(detail),
                             ground_truth=bool(ground_truth),
                             source=str(source))
            self._next_seq += 1
            self._events.append(ev)
        self._counter.labels(kind=kind).inc()
        return ev

    def record_throttled(self, kind: str, detail: str = "", *,
                         key: str = "", min_interval_s: float = 1.0,
                         ground_truth: bool = False, source: str = "",
                         now: Optional[float] = None,
                         **scope) -> Optional[ChangeEvent]:
        """Like :meth:`record` but drops repeats of (kind, key) inside
        ``min_interval_s`` — for high-rate sites (per-request tenant
        sheds) where a flood must not evict the deploy event that
        explains it out of the ring.  Returns None on a drop."""
        at = self._clock() if now is None else float(now)
        tk = (kind, key)
        with self._lock:
            last = self._throttle.get(tk)
            if last is not None and (at - last) < min_interval_s:
                self.dropped += 1
                return None
            self._throttle[tk] = at
        return self.record(kind, detail, ground_truth=ground_truth,
                           source=source, now=at, **scope)

    # ------------------------------------------------------------ read
    def events(self, since: Optional[float] = None,
               until: Optional[float] = None) -> List[ChangeEvent]:
        """Events with ``since <= at <= until`` (inclusive, either
        side optional), oldest first."""
        with self._lock:
            evs = list(self._events)
        if since is not None:
            evs = [e for e in evs if e.at >= since]
        if until is not None:
            evs = [e for e in evs if e.at <= until]
        return evs

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def snapshot(self, limit: int = 128) -> dict:
        """The newest ``limit`` events plus counts, as plain dicts."""
        with self._lock:
            evs = list(self._events)[-max(0, int(limit)):]
            recorded = self._next_seq
        return {"events": [e.to_dict() for e in evs],
                "recorded": recorded,
                "dropped_throttled": self.dropped,
                "capacity": self.capacity}


# ---------------------------------------------------------------------------
# the process-wide journal subsystems record into
# ---------------------------------------------------------------------------

_default_lock = threading.Lock()
_default: Optional[ChangeJournal] = None


def default_journal() -> ChangeJournal:
    """The process-wide change journal.  Serving/resilience internals
    record into it unconditionally (writes are cheap); an
    :class:`~.incidents.IncidentEngine` built without an explicit
    journal adopts it, so one capture sees the whole process."""
    global _default
    with _default_lock:
        if _default is None:
            _default = ChangeJournal()
        return _default


def reset_default_journal(
        clock: Optional[Callable[[], float]] = None) -> ChangeJournal:
    """Swap in a fresh default journal (tests/benches isolate with
    this; ``clock`` lets a bench pin the journal to its fake clock)."""
    global _default
    with _default_lock:
        _default = ChangeJournal(clock=clock)
        return _default


def record_change(kind: str, detail: str = "", *,
                  ground_truth: bool = False, source: str = "",
                  now: Optional[float] = None,
                  throttle_key: Optional[str] = None,
                  min_interval_s: float = 1.0,
                  **scope) -> Optional[ChangeEvent]:
    """Record into the process-wide journal (the one-line call every
    instrumented subsystem makes).  ``throttle_key`` switches to the
    throttled path."""
    j = default_journal()
    if throttle_key is not None:
        return j.record_throttled(kind, detail, key=throttle_key,
                                  min_interval_s=min_interval_s,
                                  ground_truth=ground_truth,
                                  source=source, now=now, **scope)
    return j.record(kind, detail, ground_truth=ground_truth,
                    source=source, now=now, **scope)
