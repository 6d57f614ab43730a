"""Cross-replica request tracing — sink, recorder, stitcher
(counterpart of ``bigdl_tpu/serving/request_trace.py``).

The fleet makes requests hop replicas (retries, hedges, the
prefill→decode handoff); the per-process tracer left three
unstitchable span fragments per hedged request.  This module closes
the loop:

* :class:`ReplicaTraceSink` — bound into each replica: request-phase
  spans (``queue`` / ``batch`` / ``execute`` / ``prefill`` /
  ``decode`` / ``kv_gather`` / ``error`` — the shared vocabulary in
  :mod:`bigdl_tpu_torch.telemetry.trace_context`) land in the replica's own
  :class:`~bigdl_tpu_torch.telemetry.Tracer` ring AND accumulate per trace;
  when the request resolves, the fragment publishes over the elastic
  KV transport under ``trc/<incarnation>/<trace_id>/<host>`` riding a
  :class:`~bigdl_tpu_torch.telemetry.BackgroundPublisher` — the hot path
  never blocks on transport I/O.
* :class:`RequestTracer` — router-side: mints the
  :class:`~bigdl_tpu_torch.telemetry.trace_context.TraceContext` at submit,
  records the root ``request`` span and one ``attempt`` span per
  dispatch (primary / retry / hedge — each carrying the REMAINING
  deadline budget at fork time), runs the
  :class:`~bigdl_tpu_torch.telemetry.trace_context.TailSampler` at
  completion, and **stitches** kept traces: fragments are collected
  from the KV keyspace, clock-aligned per host (mono/wall anchor
  pairs), hedge-loser attempts labeled ``hedge_outcome=lost``, and the
  whole thing exported as one cross-replica Perfetto (Chrome-trace)
  timeline — one pid per host.
* :func:`trace_coverage` / :func:`trace_attribution` — the analysis
  layer a trace report builds on: span-union coverage of
  the request wall clock (lost hedges excluded, so duplicate duty is
  never double-counted) and the queue/compute/transport phase
  attribution whose argmax names the critical path.
"""
from __future__ import annotations

import json
import logging
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

from ..telemetry.publish import BackgroundPublisher
from ..telemetry.trace_context import (TailSampler, TraceContext,
                                       TRACE_KV_PREFIX, trace_key)
from ..telemetry.tracer import Tracer, _check_category

log = logging.getLogger("bigdl_tpu")

__all__ = [
    "ReplicaTraceSink", "RequestTracer", "stitch_fragments",
    "trace_attribution", "trace_coverage",
]

#: phase attribution buckets the critical-path analysis reports: every
#: stitched span category maps into exactly one
PHASE_OF_CATEGORY = {
    "queue": "queue",
    "batch": "batch",
    "execute": "compute",
    "prefill": "compute",
    "decode": "compute",
    "kv_gather": "kv",
    "handoff": "transport",
    "swap_window": "swap",
    "error": "error",
}


def _clock_anchor(mono_clock: Callable[[], float]) -> dict:
    """A (monotonic, wall) clock pair sampled back-to-back — what lets
    the stitcher map another host's monotonic timeline onto its own."""
    return {"mono": float(mono_clock()), "wall": time.time()}


class ReplicaTraceSink:
    """Per-replica request-span recorder + background KV publisher.

    ``transport=None`` keeps fragments local (the router-side sink and
    unit tests); with a transport, :meth:`finish` publishes the
    fragment under ``trc/<incarnation>/<trace_id>/<host>`` through a
    never-blocking :class:`BackgroundPublisher`.
    """

    def __init__(self, host: str, transport=None,
                 incarnation_of: Optional[Callable[[], int]] = None,
                 publisher: Optional[BackgroundPublisher] = None,
                 capacity: int = 4096, max_traces: int = 512,
                 eager_publish: bool = True,
                 clock: Callable[[], float] = time.monotonic):
        self.host = str(host)
        self.transport = transport
        #: eager: publish the fragment the moment the request resolves
        #: (standalone servers).  Lazy (the fleet wiring): buffer it
        #: and publish only when the router's TAIL decision keeps the
        #: trace (``publish_trace`` via ``RequestTracer.on_keep``) —
        #: dropped traces never touch the transport, which is what
        #: keeps tracing overhead inside the <=3% budget
        self.eager_publish = bool(eager_publish)
        self._incarnation_of = incarnation_of or (lambda: 0)
        self.tracer = Tracer(capacity=capacity, clock=clock)
        self._clock = clock
        self._lock = threading.Lock()
        # trace_id -> [span dicts]; bounded, oldest trace evicted
        self._by_trace: "OrderedDict[str, List[dict]]" = OrderedDict()
        self.max_traces = int(max_traces)
        self._next_span_id = 0
        self._bound: set = set()   # traces mirrored into the ring
        # recent hot-swap/canary windows: attached to any overlapping
        # trace at publish time (a canary stall explains a latency
        # spike better than "queue" ever could)
        self._swaps: List[dict] = []
        self.published = 0
        self.evicted_traces = 0
        self._publisher = publisher
        self._own_publisher = publisher is None

    # ------------------------------------------------------------ recording
    def record(self, ctx: Optional[TraceContext], name: str,
               category: str, start: float, duration: float,
               **args) -> None:
        """Retro-record one request-phase span for ``ctx`` (no-op for
        untraced / unsampled requests — the cost when tracing is off is
        one None check)."""
        if ctx is None or not ctx.sampled:
            return
        self.record_raw(ctx.trace_id, ctx.span_id, ctx.attempt, name,
                        category, start, duration, **args)

    def record_raw(self, trace_id: str, parent_span_id: int,
                   attempt: int, name: str, category: str,
                   start: float, duration: float, **args) -> None:
        """The context-free spelling.  Hot path: ONE dict + one lock —
        the span dict lands in the per-trace buffer; binding into the
        replica's Tracer ring happens at :meth:`fragment` time (i.e.
        for traces the tail sampler kept), never per request."""
        _check_category(category)
        args.update(trace_id=trace_id, parent_span_id=parent_span_id,
                    attempt=attempt, host=self.host)
        span = {"name": str(name), "cat": category,
                "start": float(start),
                "dur": max(0.0, float(duration)),
                "tid": threading.get_ident(), "args": args}
        with self._lock:
            self._next_span_id += 1
            span["id"] = self._next_span_id
            spans = self._by_trace.get(trace_id)
            if spans is None:
                spans = self._by_trace[trace_id] = []
                while len(self._by_trace) > self.max_traces:
                    self._by_trace.popitem(last=False)
                    self.evicted_traces += 1
            spans.append(span)

    def _bind_ring(self, trace_id: str, spans: List[dict]) -> None:
        """Mirror one kept trace's spans into the replica's Tracer
        ring (replica-local Perfetto export / category totals) — once
        per trace, off the request hot path."""
        with self._lock:
            if trace_id in self._bound:
                return
            self._bound.add(trace_id)
            while len(self._bound) > 4 * self.max_traces:
                self._bound.pop()
        for sp in spans:
            try:
                self.tracer.record(sp["name"], sp["cat"], sp["start"],
                                   sp["dur"], **(sp.get("args") or {}))
            except ValueError:
                pass

    def record_swap_window(self, start: float, duration: float,
                           outcome: str) -> None:
        """One hot-swap/canary window (``outcome``: ``installed`` |
        ``rejected``) — kept in a bounded recent list and attached to
        overlapping traces at publish."""
        span = self.tracer.record("swap", "swap_window", start,
                                  duration, host=self.host,
                                  outcome=outcome)
        if span is None:
            return
        with self._lock:
            self._swaps.append(span.to_dict())
            del self._swaps[:-64]

    # ------------------------------------------------------------ publishing
    def publisher(self) -> BackgroundPublisher:
        if self._publisher is None:
            self._publisher = BackgroundPublisher(
                incarnation_of=None,
                name=f"bigdl-trace-{self.host}")
        return self._publisher

    def fragment(self, trace_id: str) -> Optional[dict]:
        """The fragment payload for one trace (overlapping swap
        windows included), or None when nothing was recorded.  Called
        for KEPT traces (publish / stitch) — this is also where the
        trace binds into the replica's Tracer ring."""
        with self._lock:
            spans = list(self._by_trace.get(trace_id) or ())
            swaps = list(self._swaps)
        if not spans:
            return None
        self._bind_ring(trace_id, spans)
        t0 = min(s["start"] for s in spans)
        t1 = max(s["start"] + s["dur"] for s in spans)
        for sw in swaps:
            if sw["start"] < t1 and sw["start"] + sw["dur"] > t0:
                spans.append(sw)
        return {
            "host": self.host,
            "trace_id": trace_id,
            "incarnation": int(self._incarnation_of() or 0),
            "spans": spans,
            "clock_anchor": _clock_anchor(self._clock),
        }

    def finish(self, ctx: Optional[TraceContext]) -> None:
        """The request resolved on this replica: with eager
        publishing, queue its fragment now; with lazy (fleet)
        publishing, leave it buffered for the router's tail decision
        (``publish_trace``)."""
        if ctx is None or not ctx.sampled:
            return
        if self.eager_publish:
            self.publish_trace(ctx.trace_id)

    def publish_trace(self, trace_id: str) -> None:
        """Queue one trace's fragment for background publication
        (coalesced per (trace, host) — a decode retry on the same
        replica republishes the superset)."""
        if self.transport is None:
            return

        def publish():
            frag = self.fragment(trace_id)
            if frag is None:
                return
            self.transport.put(
                trace_key(frag["incarnation"], trace_id, self.host),
                json.dumps(frag))
            with self._lock:
                self.published += 1

        self.publisher().submit(publish,
                                key=f"trc:{trace_id}:{self.host}")

    def flush(self, timeout: float = 5.0) -> bool:
        """Drain pending fragment publications (the stitcher's read
        barrier)."""
        if self._publisher is None:
            return True
        return self._publisher.drain(timeout=timeout)

    def close(self):
        if self._publisher is not None and self._own_publisher:
            self._publisher.close()

    def snapshot(self) -> dict:
        with self._lock:
            return {"host": self.host,
                    "open_traces": len(self._by_trace),
                    "published": self.published,
                    "evicted_traces": self.evicted_traces,
                    "spans_dropped": self.tracer.dropped}


class _TraceState:
    """Router-side bookkeeping for one in-flight traced request.

    Attempt/root spans are BUFFERED here (plain dicts, no tracer
    traffic) and only materialize into the router sink when the tail
    sampler keeps the trace — a dropped trace costs zero router-side
    span records, which is what keeps tracing overhead inside its
    budget.  A hedge loser closing after the keep decision
    materializes late (``kept`` flag)."""

    __slots__ = ("ctx", "kind", "t0", "lock", "next_span_id",
                 "attempts", "lost_attempts", "retried", "hedged",
                 "deadline_s", "queue_window", "handoffs", "kept")

    def __init__(self, ctx: TraceContext, kind: str, t0: float,
                 deadline_s: Optional[float]):
        self.ctx = ctx
        self.kind = kind
        self.t0 = t0
        self.lock = threading.Lock()
        self.next_span_id = 1      # 1 = the root request span
        self.attempts: List[dict] = []
        self.lost_attempts: set = set()
        self.retried = False
        self.hedged = False
        self.deadline_s = deadline_s
        self.queue_window: Optional[tuple] = None
        self.handoffs: List[dict] = []
        self.kept = False

    def alloc_span_id(self) -> int:
        with self.lock:
            self.next_span_id += 1
            return self.next_span_id


class RequestTracer:
    """The router side: context minting, attempt spans, tail sampling,
    and stitching.  One per :class:`~.router.FleetRouter`."""

    def __init__(self, transport=None,
                 incarnation_of: Optional[Callable[[], int]] = None,
                 sampler: Optional[TailSampler] = None,
                 host: str = "router", keep_max: int = 256,
                 clock: Callable[[], float] = time.monotonic):
        self.transport = transport
        self._clock = clock
        self.sampler = sampler or TailSampler()
        self.sink = ReplicaTraceSink(host, transport=None,
                                     incarnation_of=incarnation_of,
                                     clock=clock)
        self._lock = threading.Lock()
        self._kept: "OrderedDict[str, dict]" = OrderedDict()
        self.keep_max = int(keep_max)
        self.minted = 0
        #: called with the trace_id of every KEPT trace (the fleet
        #: wires it to each replica sink's ``publish_trace`` — the
        #: tail decision pulls fragments onto the transport)
        self.on_keep: Optional[Callable[[str], None]] = None

    # ------------------------------------------------------------ lifecycle
    def begin(self, kind: str,
              deadline_s: Optional[float]) -> _TraceState:
        ctx = TraceContext.mint(deadline_s=deadline_s)
        with self._lock:
            self.minted += 1
        return _TraceState(ctx, kind, self._clock(), deadline_s)

    def router_queue(self, state: _TraceState, t_start: float,
                     t_end: float) -> None:
        """The router-pool wait between enqueue and the drive thread
        picking the request up (buffered; materialized on keep)."""
        state.queue_window = (t_start, max(0.0, t_end - t_start))

    def handoff(self, state: _TraceState, t_start: float,
                duration: float, **args) -> None:
        """The router-side prefill→decode handoff hop (buffered;
        materialized on keep)."""
        with state.lock:
            state.handoffs.append({"t_start": t_start,
                                   "duration": duration, "args": args})

    def attempt_begin(self, state: _TraceState, replica: str,
                      kind: str, remaining_s: Optional[float],
                      hedge: bool = False) -> TraceContext:
        """Fork the context for one dispatch attempt; the wire form of
        the returned child is what rides ``submit(..., trace=...)``."""
        span_id = state.alloc_span_id()
        with state.lock:
            idx = len(state.attempts)
            state.attempts.append({
                "span_id": span_id, "replica": replica, "kind": kind,
                "t_start": self._clock(), "hedge": bool(hedge),
                "remaining_s": remaining_s, "index": idx,
            })
            if hedge:
                state.hedged = True
            elif idx > 0:
                state.retried = True
        phase = kind if kind in ("prefill", "decode") else None
        return state.ctx.child(span_id, remaining_s=remaining_s,
                               attempt=idx, phase=phase)

    def attempt_end(self, state: _TraceState, ctx: TraceContext,
                    status: Optional[str],
                    hedge_outcome: Optional[str] = None) -> None:
        """Close one attempt — including a hedge loser at DISCARD time
        (``hedge_outcome="lost"``), so duplicate duty is labeled
        instead of leaking as an orphan.  Buffered until the trace is
        kept; a loser closing after the keep decision materializes
        immediately."""
        with state.lock:
            att = state.attempts[ctx.attempt]
            if att.get("closed"):
                return
            att["closed"] = True
            att["t_end"] = self._clock()
            att["status"] = status
            if hedge_outcome is not None:
                att["hedge_outcome"] = hedge_outcome
            if hedge_outcome == "lost":
                state.lost_attempts.add(ctx.attempt)
            late = state.kept
        if late:
            self._record_attempt(state, att)

    def _record_attempt(self, state: _TraceState, att: dict) -> None:
        args = {"replica": att["replica"], "kind": att["kind"],
                "status": att.get("status"),
                "span_id": att["span_id"],
                "remaining_budget_s": att["remaining_s"]}
        if att["hedge"]:
            args["hedge"] = True
        if att.get("hedge_outcome") is not None:
            args["hedge_outcome"] = att["hedge_outcome"]
        # attempt spans parent the ROOT span (id 1)
        self.sink.record_raw(
            state.ctx.trace_id, 1, att["index"],
            f"attempt:{att['replica']}", "attempt", att["t_start"],
            att.get("t_end", att["t_start"]) - att["t_start"], **args)

    def mark_lost(self, state: _TraceState, ctx: TraceContext) -> None:
        """Record — at winner time — that this attempt's response will
        be discarded, so the stitcher labels its replica spans even
        before the loser's late response arrives."""
        with state.lock:
            state.lost_attempts.add(ctx.attempt)

    def finish(self, state: _TraceState, status: str, ok: bool,
               latency_s: float,
               p99_s: Optional[float]) -> Optional[str]:
        """Run the tail sampler; on keep, materialize the buffered
        root/queue/attempt spans into the router sink and fire
        ``on_keep``.  Returns the keep reason (None = dropped: the
        request's trace state cost zero tracer traffic and is simply
        released)."""
        reason = self.sampler.keep(
            ok=ok, retried=state.retried, hedged=state.hedged,
            latency_s=latency_s, p99_s=p99_s)
        if reason is None:
            return None
        with state.lock:
            state.kept = True
            closed = [a for a in state.attempts if a.get("closed")]
            handoffs = list(state.handoffs)
        # multi-tenant attribution rides the root span + kept summary:
        # one kept trace names the tenant/model/version it served
        tenancy = {}
        if state.ctx.tenant is not None:
            tenancy = {"tenant": state.ctx.tenant,
                       "model": state.ctx.model,
                       "model_version": state.ctx.model_version}
        self.sink.record(state.ctx, f"request:{state.kind}", "request",
                         state.t0, latency_s, kind=state.kind,
                         status=status, span_id=1,
                         deadline_s=state.deadline_s,
                         retried=state.retried, hedged=state.hedged,
                         keep_reason=reason,
                         lost_attempts=sorted(state.lost_attempts),
                         **tenancy)
        if state.queue_window is not None:
            self.sink.record(state.ctx, "router_queue", "queue",
                             state.queue_window[0],
                             state.queue_window[1])
        for att in closed:
            self._record_attempt(state, att)
        for h in handoffs:
            self.sink.record(state.ctx, "handoff", "handoff",
                             h["t_start"], h["duration"], **h["args"])
        with self._lock:
            self._kept[state.ctx.trace_id] = {
                "trace_id": state.ctx.trace_id, "kind": state.kind,
                "status": status, "latency_s": latency_s,
                "reason": reason, "t0": state.t0,
                "retried": state.retried, "hedged": state.hedged,
                "lost_attempts": sorted(state.lost_attempts),
                **tenancy,
            }
            while len(self._kept) > self.keep_max:
                self._kept.popitem(last=False)
        if self.on_keep is not None:
            try:
                self.on_keep(state.ctx.trace_id)
            except Exception:
                log.warning("trace on_keep hook failed",
                            exc_info=True)
        return reason

    # ------------------------------------------------------------ stitching
    def kept_traces(self) -> List[dict]:
        with self._lock:
            return [dict(v) for v in self._kept.values()]

    def _kv_fragments(self, trace_id: str) -> List[dict]:
        """Every host's published fragment for one trace, across
        incarnations (a mid-trace eject bumps the incarnation between
        two replicas' publishes — both halves still stitch)."""
        if self.transport is None:
            return []
        needle = f"/{trace_id}/"
        out = []
        for key in self.transport.keys(TRACE_KV_PREFIX):
            if needle not in key:
                continue
            raw = self.transport.get(key)
            if raw is None:
                continue
            try:
                out.append(json.loads(raw))
            except ValueError:
                continue
        return out

    def stitch(self, trace_id: str,
               skew: Optional[Dict[str, dict]] = None,
               flush_sinks: Optional[List[ReplicaTraceSink]] = None
               ) -> Optional[dict]:
        """One cross-replica Perfetto (Chrome-trace) timeline for a
        kept trace: the router fragment plus every replica's KV
        fragment, clock-aligned onto the router's monotonic timeline,
        hedge-loser attempts labeled.  ``skew`` (host → ``{"skew":
        ratio}``, e.g. the fleet/cluster snapshot's per-host step-time
        skew) rides onto each host's process metadata."""
        for s in flush_sinks or ():
            # lazily-published sinks may still hold this trace's
            # fragment: pull it (coalesced no-op when already queued)
            s.publish_trace(trace_id)
            s.flush()
        router_frag = self.sink.fragment(trace_id)
        frags = self._kv_fragments(trace_id)
        if router_frag is not None:
            frags.insert(0, router_frag)
        if not frags:
            return None
        with self._lock:
            kept = self._kept.get(trace_id)
        lost = set((kept or {}).get("lost_attempts") or ())
        return stitch_fragments(frags, reference_host=self.sink.host,
                                lost_attempts=lost, skew=skew,
                                summary=kept)

    def snapshot(self) -> dict:
        return {
            "minted": self.minted,
            "sampler": self.sampler.snapshot(),
            "kept_traces": len(self._kept),
            "router_sink": self.sink.snapshot(),
        }

    def close(self):
        self.sink.close()


# ---------------------------------------------------------------------------
# stitching + analysis (pure functions)
# ---------------------------------------------------------------------------

def stitch_fragments(fragments: List[dict],
                     reference_host: str = "router",
                     lost_attempts: Optional[set] = None,
                     skew: Optional[Dict[str, dict]] = None,
                     summary: Optional[dict] = None) -> dict:
    """Fold per-host fragments into one Chrome-trace dict: one pid per
    host (process_name metadata), timestamps mapped onto the reference
    host's monotonic clock via each fragment's (mono, wall) anchor
    pair, lost-hedge attempts' spans labeled ``hedge_outcome=lost``."""
    lost = lost_attempts or set()
    ref = next((f for f in fragments
                if f.get("host") == reference_host), fragments[0])
    ref_anchor = ref.get("clock_anchor") or {}
    ref_delta = (ref_anchor.get("wall", 0.0)
                 - ref_anchor.get("mono", 0.0))
    events = []
    hosts = []
    for frag in fragments:
        host = str(frag.get("host", "?"))
        if host not in hosts:
            hosts.append(host)
        pid = hosts.index(host) + 1
        anchor = frag.get("clock_anchor") or {}
        # host mono -> reference mono: synchronized wall clocks anchor
        # the two monotonic timelines (offset ~0 in-process; the real
        # cross-host correction in production)
        offset = ((anchor.get("wall", 0.0) - anchor.get("mono", 0.0))
                  - ref_delta) if anchor and ref_anchor else 0.0
        host_skew = (skew or {}).get(host) or {}
        meta_args = {"host": host}
        if host_skew:
            meta_args["step_time_skew"] = host_skew.get("skew")
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": host, **meta_args}})
        for sp in frag.get("spans", ()):
            args = dict(sp.get("args") or {})
            if args.get("attempt") in lost \
                    and args.get("hedge_outcome") is None \
                    and sp.get("cat") != "request":
                args["hedge_outcome"] = "lost"
            events.append({
                "name": sp["name"], "cat": sp["cat"], "ph": "X",
                "ts": (sp["start"] + offset) * 1e6,
                "dur": sp["dur"] * 1e6,
                "pid": pid, "tid": sp.get("tid", 0),
                "args": args,
            })
    out = {"traceEvents": events, "displayTimeUnit": "ms",
           "hosts": hosts}
    if summary:
        out["summary"] = dict(summary)
    return out


def _span_events(trace: dict, include_lost: bool = False) -> List[dict]:
    return [e for e in trace.get("traceEvents", ())
            if e.get("ph") == "X"
            and (include_lost
                 or (e.get("args") or {}).get("hedge_outcome")
                 != "lost")]


def _root_event(trace: dict) -> Optional[dict]:
    roots = [e for e in _span_events(trace, include_lost=True)
             if e.get("cat") == "request"]
    return roots[0] if roots else None


def _union_seconds(intervals: List[Tuple[float, float]]) -> float:
    total = 0.0
    end = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def trace_coverage(trace: dict) -> Optional[float]:
    """Fraction of the root request's wall clock covered by the union
    of its child spans.  Hedge losers MAY contribute to the union — a
    union cannot double-count, and the pre-hedge wait is legitimately
    covered by the (discarded) primary attempt — while the phase SUMS
    in :func:`trace_attribution` exclude them.  None without a root
    span."""
    root = _root_event(trace)
    if root is None or root.get("dur", 0) <= 0:
        return None
    r0, r1 = root["ts"], root["ts"] + root["dur"]
    ivs = []
    for e in _span_events(trace, include_lost=True):
        if e is root or e.get("cat") in ("request", "swap_window"):
            continue
        a = max(r0, e["ts"])
        b = min(r1, e["ts"] + e.get("dur", 0))
        if b > a:
            ivs.append((a, b))
    return min(1.0, _union_seconds(ivs) / (r1 - r0))


def trace_attribution(trace: dict) -> Optional[dict]:
    """Where one request's wall clock went: seconds per phase (queue /
    batch / compute / kv / swap / transport), per-replica compute
    seconds, and the critical-path phase (argmax).  ``transport`` is
    the unattributed remainder — the cross-process hops no single
    host's spans can see."""
    root = _root_event(trace)
    if root is None or root.get("dur", 0) <= 0:
        return None
    r0, r1 = root["ts"], root["ts"] + root["dur"]
    wall = (r1 - r0) / 1e6
    phases: Dict[str, float] = {}
    by_replica: Dict[str, float] = {}
    covered = []
    for e in _span_events(trace):
        cat = e.get("cat")
        if e is root or cat in ("request", "attempt"):
            continue
        phase = PHASE_OF_CATEGORY.get(cat)
        if phase is None:
            continue
        a = max(r0, e["ts"])
        b = min(r1, e["ts"] + e.get("dur", 0))
        if b <= a:
            continue
        secs = (b - a) / 1e6
        phases[phase] = phases.get(phase, 0.0) + secs
        if phase != "swap":
            covered.append((a, b))
        if phase == "compute":
            host = (e.get("args") or {}).get("host", "?")
            by_replica[host] = by_replica.get(host, 0.0) + secs
    phases["transport"] = max(
        0.0, wall - _union_seconds(covered) / 1e6)
    ranked = sorted(
        ((s, p) for p, s in phases.items() if p != "swap"),
        reverse=True)
    critical = ranked[0][1] if ranked else None
    busiest = max(by_replica.items(), key=lambda kv: kv[1])[0] \
        if by_replica else None
    root_args = root.get("args") or {}
    return {
        "wall_s": wall,
        "tenant": root_args.get("tenant"),
        "model": root_args.get("model"),
        "phases": {p: round(s, 6) for p, s in sorted(phases.items())},
        "compute_by_replica": {h: round(s, 6)
                               for h, s in sorted(by_replica.items())},
        "critical_phase": critical,
        "critical_replica": busiest,
        "coverage": trace_coverage(trace),
    }
