"""Incident engine: black-box capture + causal attribution over the
change journal.

The SLO engine (:mod:`.slo`) answers *that* something broke; the
change journal (:mod:`.events`) records *what changed*; this module
joins them.  An :class:`IncidentEngine` subscribes to SLO alert
transitions (chain :meth:`observe` after ``SloEngine.evaluate`` —
the :class:`~bigdl_tpu_torch.serving.health.FleetHealthMonitor` does this
when built with one).  On a rule's ``ok → firing`` edge it opens an
:class:`Incident` and freezes the **black box**:

* the breached metric's own time-series slice over the pre-window,
  plus correlated series — every recorder series whose label set
  shares a (key, value) with the breached rule's labels, capped;
* the journal slice covering ``[breach - pre_window, finalize]``;
* optionally, kept traces in-window from a pluggable
  ``trace_provider(since, until) -> list`` (the tail sampler's store
  lives fleet-side, so the provider is injected, not imported).

The incident stays open for ``post_intervals`` further observe rounds
(the post-window — events landing *after* the breach still make the
timeline), then finalizes:

1. **Deflection onset** — the breached series' pre-window samples are
   scanned for the first point deviating > 3 robust sigmas (MAD) from
   the pre-window baseline; the alert's ``for_intervals`` hysteresis
   means the true onset PRECEDES the firing edge, and alignment
   against onset, not breach, is what separates the deploy that
   caused the regression from the autoscale move that reacted to it.
2. **Suspect ranking** — every journal event in the capture window is
   scored: *scope match* (a (key, value) shared with the breached
   labels outranks fleet-wide; a conflicting value ranks below it) +
   *time proximity* to onset (earlier-and-near beats later;
   effect-before-cause is damped, not excluded — clock granularity) +
   a small *disruptiveness prior* on kinds that historically cause
   incidents (deploys, evictions, chaos).  Ties break on journal
   order.  The ranked list is the incident's answer to "what
   changed?"; ``ground_truth`` events let benches score it.

Snapshots publish through :meth:`Telemetry.payload` (``incidents``
key) and fold cluster-wide via
:func:`~.aggregate.merge_incidents`, exactly like alerts.
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from . import metric_names as M
from .events import ChangeEvent, ChangeJournal, default_journal
from .registry import default_registry
from .timeseries import MetricRecorder

__all__ = ["Incident", "IncidentEngine", "IncidentPolicy"]

#: kinds that historically *cause* incidents (vs react to them) —
#: a small additive prior, never enough to outrank a scope match
_DISRUPTIVE_KINDS = frozenset({
    "deploy_started", "deploy_rolled_back", "membership_evict",
    "replica_removed", "chaos_inject",
})


@dataclass
class IncidentPolicy:
    """Capture-window + ranking knobs."""
    #: seconds of pre-breach history frozen into the black box
    pre_window_s: float = 60.0
    #: observe rounds the incident stays open post-breach
    post_intervals: int = 3
    #: correlated series captured besides the breached one (cap)
    max_correlated: int = 8
    #: ranked suspects kept on the finalized incident
    max_suspects: int = 5
    #: samples kept per captured series (newest first wins)
    max_samples: int = 256
    #: a rule that re-fires within this many seconds of its last
    #: incident's open does NOT open a second one (flap guard)
    cooldown_s: float = 30.0
    #: proximity decay constant (seconds) for the time-alignment term
    proximity_tau_s: float = 15.0


@dataclass
class Incident:
    """One opened (and eventually finalized) incident bundle."""
    id: str
    rule: str
    severity: str
    opened_at: float               # metric-clock time of the breach
    value: Optional[float]
    labels: Dict[str, str] = field(default_factory=dict)
    status: str = "open"           # open | finalized
    onset_at: Optional[float] = None
    #: {"<family>|<field>|<labels-json>": [[t, v], ...]}
    series: Dict[str, List] = field(default_factory=dict)
    events: List[dict] = field(default_factory=list)
    traces: List = field(default_factory=list)
    suspects: List[dict] = field(default_factory=list)
    finalized_at: Optional[float] = None
    capture_latency_s: float = 0.0
    rounds_left: int = 0

    def to_dict(self) -> dict:
        return {
            "id": self.id, "rule": self.rule,
            "severity": self.severity,
            "opened_at": round(self.opened_at, 6),
            "value": self.value, "labels": dict(self.labels),
            "status": self.status,
            "onset_at": (round(self.onset_at, 6)
                         if self.onset_at is not None else None),
            "series": {k: [[round(t, 6), v] for t, v in s]
                       for k, s in self.series.items()},
            "events": list(self.events),
            "traces": list(self.traces),
            "suspects": list(self.suspects),
            "finalized_at": self.finalized_at,
            "capture_latency_s": round(self.capture_latency_s, 6),
        }


class IncidentEngine:
    """Opens, captures and attributes incidents — see the module
    docstring.

    Parameters
    ----------
    recorder : the :class:`~.timeseries.MetricRecorder` the SLO rules
        evaluate over (the black box slices ITS series).
    journal : the :class:`~.events.ChangeJournal` to align against
        (default: the process-wide journal).
    engine : optional :class:`~.slo.SloEngine` — lets the capture
        resolve a firing rule's family/labels (without it, only the
        alert's label set scopes the capture).
    trace_provider : optional ``(since, until) -> list`` returning
        kept-trace summaries in-window.
    """

    def __init__(self, recorder: MetricRecorder,
                 journal: Optional[ChangeJournal] = None,
                 engine=None,
                 policy: Optional[IncidentPolicy] = None,
                 registry=None,
                 trace_provider: Optional[
                     Callable[[float, float], list]] = None,
                 clock: Optional[Callable[[], float]] = None,
                 max_incidents: int = 32):
        self.recorder = recorder
        self.journal = journal if journal is not None \
            else default_journal()
        self.engine = engine
        self.policy = policy or IncidentPolicy()
        self.trace_provider = trace_provider
        self.clock = clock or getattr(recorder, "clock", time.monotonic)
        self._open: Dict[str, Incident] = {}     # rule -> incident
        self._recent: deque = deque(maxlen=max(1, int(max_incidents)))
        self._last_opened: Dict[str, float] = {} # rule -> opened_at
        self._lock = threading.Lock()
        self._n = 0
        reg = registry if registry is not None else default_registry()
        self._ctr = reg.counter(
            M.INCIDENTS_TOTAL, "incidents opened",
            labels=("severity",))
        self._gauge = reg.gauge(
            M.INCIDENTS_ACTIVE,
            "incidents holding an open capture window")

    # ------------------------------------------------------------ rules
    def _rule_obj(self, name: str):
        if self.engine is None:
            return None
        for r in self.engine.rules:
            if r.name == name:
                return r
        return None

    # ------------------------------------------------------------ observe
    def observe(self, transitions=None,
                now: Optional[float] = None) -> List[Incident]:
        """One round: open incidents for fresh ``firing`` transitions,
        advance the post-window of everything already open, finalize
        what expired.  ``transitions`` accepts
        :class:`~.slo.Alert` objects or their dicts (what
        ``SloEngine.evaluate`` / ``FleetHealthMonitor.observe``
        return).  Returns incidents finalized THIS round."""
        now = self.clock() if now is None else float(now)
        opened_now = set()
        for tr in (transitions or ()):
            a = tr if isinstance(tr, dict) else tr.to_dict()
            if a.get("state") != "firing":
                continue
            if self._maybe_open(a, now):
                opened_now.add(str(a.get("rule")))
        return self._advance(now, skip=opened_now)

    def _maybe_open(self, alert: dict, now: float) -> bool:
        rule = str(alert.get("rule"))
        with self._lock:
            if rule in self._open:
                return False
            last = self._last_opened.get(rule)
            if last is not None \
                    and (now - last) < self.policy.cooldown_s:
                return False
            self._n += 1
            inc = Incident(
                id=f"inc-{self._n:04d}", rule=rule,
                severity=str(alert.get("severity") or "page"),
                opened_at=float(alert.get("at") or now),
                value=alert.get("value"),
                labels=dict(alert.get("labels") or {}),
                rounds_left=max(0, int(self.policy.post_intervals)))
            self._open[rule] = inc
            self._last_opened[rule] = now
        t0 = time.perf_counter()
        self._capture(inc)
        inc.capture_latency_s = time.perf_counter() - t0
        self._ctr.labels(severity=inc.severity).inc()
        self._gauge.set(len(self._open))
        return True

    # ------------------------------------------------------------ capture
    def _series_key(self, family: str, fld: str, labels: dict) -> str:
        lk = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
        return f"{family}|{fld}|{{{lk}}}"

    def _slice(self, family: str, labels: dict, fld: str,
               since: float) -> List:
        s = self.recorder.series(family, labels or None, fld)
        if s is None:
            return []
        samples = s.window(since)
        return samples[-self.policy.max_samples:]

    def _capture(self, inc: Incident):
        """Freeze the pre-window black box: the breached series plus
        scope-correlated neighbors."""
        since = inc.opened_at - self.policy.pre_window_s
        rule = self._rule_obj(inc.rule)
        breached = []
        if rule is not None and rule.family:
            key = self._series_key(rule.family, rule.signal,
                                   rule.labels)
            samples = self._slice(rule.family, rule.labels,
                                  rule.signal, since)
            if samples:
                inc.series[key] = samples
                breached = samples
            if getattr(rule, "total_family", ""):
                tkey = self._series_key(rule.total_family,
                                        rule.total_signal,
                                        rule.total_labels)
                ts = self._slice(rule.total_family, rule.total_labels,
                                 rule.total_signal, since)
                if ts:
                    inc.series[tkey] = ts
        # correlated families: any recorder series sharing a
        # (key, value) with the breached labels (capped)
        want = set((inc.labels or {}).items())
        if want:
            snap = self.recorder.snapshot()["series"]
            taken = 0
            for fam in sorted(snap):
                for entry in snap[fam]:
                    if taken >= self.policy.max_correlated:
                        break
                    labels = entry.get("labels") or {}
                    fld = entry.get("field") or "value"
                    key = self._series_key(fam, fld, labels)
                    if key in inc.series:
                        continue
                    if not (want & set(labels.items())):
                        continue
                    samples = self._slice(fam, labels, fld, since)
                    if samples:
                        inc.series[key] = samples
                        taken += 1
        inc.onset_at = self._onset(breached, inc.opened_at)

    @staticmethod
    def _onset(samples: List, breach_at: float) -> float:
        """First sample deviating > 3 robust sigmas from the
        pre-window baseline — the deflection onset the suspects align
        against.  Falls back to the breach time."""
        pre = [(t, v) for t, v in samples if t <= breach_at]
        if len(pre) < 4:
            return breach_at
        vals = sorted(v for _, v in pre)
        mid = len(vals) // 2
        med = (vals[mid] if len(vals) % 2
               else 0.5 * (vals[mid - 1] + vals[mid]))
        devs = sorted(abs(v - med) for _, v in pre)
        mad = (devs[mid] if len(devs) % 2
               else 0.5 * (devs[mid - 1] + devs[mid]))
        sigma = 1.4826 * mad
        if sigma <= 0.0:
            # constant baseline: onset is the first value that moved
            for t, v in pre:
                if v != med:
                    return t
            return breach_at
        for t, v in pre:
            if abs(v - med) > 3.0 * sigma:
                return t
        return breach_at

    # ------------------------------------------------------------ finalize
    def _advance(self, now: float, skip=()) -> List[Incident]:
        done: List[Incident] = []
        with self._lock:
            open_incs = list(self._open.items())
        for rule, inc in open_incs:
            if rule in skip:
                continue      # opened THIS round: the post-window
            inc.rounds_left -= 1     # starts next observe round
            if inc.rounds_left > 0:
                continue
            t0 = time.perf_counter()
            self._finalize(inc, now)
            inc.capture_latency_s += time.perf_counter() - t0
            with self._lock:
                self._open.pop(rule, None)
                self._recent.append(inc)
            done.append(inc)
        if done:
            self._gauge.set(len(self._open))
        return done

    def _finalize(self, inc: Incident, now: float):
        since = inc.opened_at - self.policy.pre_window_s
        events = self.journal.events(since=since, until=now)
        inc.events = [e.to_dict() for e in events]
        if self.trace_provider is not None:
            try:
                inc.traces = list(
                    self.trace_provider(since, now) or ())
            except Exception:
                inc.traces = []
        onset = inc.onset_at if inc.onset_at is not None \
            else inc.opened_at
        scored = []
        for i, ev in enumerate(events):
            scored.append((self._score(ev, inc.labels, onset), -i, ev))
        scored.sort(key=lambda s: (-s[0], s[1]))
        inc.suspects = [
            dict(ev.to_dict(), score=round(score, 4), rank=r + 1)
            for r, (score, _, ev) in
            enumerate(scored[:self.policy.max_suspects])]
        inc.status = "finalized"
        inc.finalized_at = now

    def _score(self, ev: ChangeEvent, breached: Dict[str, str],
               onset: float) -> float:
        """Scope match + time proximity + disruptiveness prior — the
        blame-ranking rules (documented in docs/observability.md)."""
        score = 0.0
        for k, v in (ev.scope or {}).items():
            want = (breached or {}).get(k)
            if want is None:
                continue
            score += 2.0 if str(want) == str(v) else -2.0
        # an event with NO scope is fleet-wide: plausible for any
        # breach, but a scoped match must outrank it
        if not ev.scope:
            score += 0.5
        dt = onset - ev.at
        tau = max(1e-6, self.policy.proximity_tau_s)
        if dt >= 0.0:
            # cause precedes effect: nearer-to-onset is stronger
            score += 1.5 * math.exp(-dt / tau)
        else:
            # event after onset: damped, not excluded (clock
            # granularity can invert cause/effect by one tick)
            score += 0.75 * math.exp(dt / tau)
        if ev.kind in _DISRUPTIVE_KINDS:
            score += 0.25
        return score

    # ------------------------------------------------------------ reading
    @property
    def opened_total(self) -> int:
        with self._lock:
            return self._n

    def open_incidents(self) -> List[Incident]:
        with self._lock:
            return list(self._open.values())

    def incidents(self) -> List[Incident]:
        """Finalized incidents, oldest first (bounded)."""
        with self._lock:
            return list(self._recent)

    def snapshot(self) -> dict:
        """The publishable view — what ``Telemetry.payload`` ships
        under ``incidents`` and ``merge_incidents`` folds."""
        with self._lock:
            open_ = [i.to_dict() for i in self._open.values()]
            recent = [i.to_dict() for i in self._recent]
            n = self._n
        return {"open": open_, "recent": recent, "opened": n}
