"""Distributed request-trace context — the one shared constant table.

A request that crosses the fleet (router → prefill replica → decode
replica, with retries and hedge duplicates along the way) used to
leave one unstitchable span fragment per process.  This module is the
*vocabulary* that lets those fragments stitch back into one trace:

* :data:`REQUEST_CATEGORIES` — the closed span-category vocabulary of
  the request path, appended to the tracer's training vocabulary
  (``telemetry.tracer.CATEGORIES``).  Router, server, and tracer all
  import THIS table; a vocabulary lint (tests/test_determinism.py)
  fails on any stringly-typed category that isn't in it.
* :data:`TRACE_KV_PREFIX` / :func:`trace_key` — the elastic-KV key
  schema trace fragments publish under:
  ``trc/<incarnation>/<trace_id>/<host>`` (incarnation-keyed exactly
  like telemetry snapshots and SDC votes, so a reconfigured fleet
  never stitches a dead membership's fragments).
* :class:`TraceContext` — the per-request context minted at
  ``FleetRouter.submit`` / ``submit_generate`` and propagated through
  every dispatch, retry, hedge duplicate, and the crc-sealed
  prefill→decode handoff blob: trace id, parent span id, the
  REMAINING deadline budget at fork time, and the sampling decision.
* :class:`TailSampler` — tail-based retention: the keep/drop decision
  runs at request COMPLETION, when the outcome is known — errors,
  sheds, retries, hedges and p99-exceeding requests are always kept;
  OK traffic is kept probabilistically under a rate budget.
"""
from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

__all__ = [
    "REQUEST_CATEGORIES", "TRACE_KV_PREFIX", "TRACE_WIRE_KEY",
    "TraceContext", "TailSampler", "trace_key", "trace_prefix",
]

#: the closed vocabulary of request-phase span categories.  Everything
#: a traced request's wall clock can be attributed to, across router
#: and replica:
#:
#: * ``request``     — the router-side root span (one per request)
#: * ``attempt``     — one dispatch attempt (primary, retry, or hedge
#:                     duplicate; hedges carry ``hedge=True`` and a
#:                     terminal ``hedge_outcome``)
#: * ``queue``       — replica admission-queue wait
#: * ``batch``       — bucket coalesce / batch-formation window
#: * ``execute``     — compiled-step execution of the request's batch
#: * ``prefill``     — prompt pass + first token (paged/disagg path)
#: * ``decode``      — the token-streaming loop
#: * ``kv_gather``   — KV page gather/scatter (handoff export/import)
#: * ``handoff``     — the sealed prefill→decode handoff hop
#: * ``swap_window`` — a hot-swap/canary window overlapping the request
#: * ``error``       — a typed failure (status + error ride the args)
REQUEST_CATEGORIES = (
    "request", "attempt", "queue", "batch", "execute",
    "prefill", "decode", "kv_gather", "handoff", "swap_window",
    "error",
)

#: KV key prefix for published trace fragments (next to ``tm/`` and
#: ``sdc/`` in the elastic keyspace)
TRACE_KV_PREFIX = "trc/"

#: the key a TraceContext rides under in wire dicts (handoff-blob
#: extras, submit kwargs) — one name, no stringly drift
TRACE_WIRE_KEY = "trace"


def trace_prefix(incarnation: int, trace_id: str) -> str:
    """Key prefix of every host's fragment for one trace."""
    return f"{TRACE_KV_PREFIX}{int(incarnation)}/{trace_id}/"


def trace_key(incarnation: int, trace_id: str, host: str) -> str:
    """``trc/<incarnation>/<trace_id>/<host>`` — one fragment per
    (trace, host), newest-wins like telemetry snapshots."""
    return trace_prefix(incarnation, trace_id) + str(host)


@dataclass
class TraceContext:
    """The context one request carries across process boundaries.

    ``deadline_s`` is the REMAINING budget at the point this context
    was minted or forked — each retry forks a child with the budget
    that actually remains, so a stitched trace shows the budget
    draining across attempts.  ``sampled`` is the head decision
    (record spans at all); retention is decided tail-side by
    :class:`TailSampler` when the outcome is known.
    """
    trace_id: str
    span_id: int = 1            # parent span id for remote children
    deadline_s: Optional[float] = None
    sampled: bool = True
    attempt: int = 0
    phase: Optional[str] = None  # prefill | decode | None
    #: multi-tenant attribution — which tenant/model/version this
    #: request belongs to, so one kept trace is enough to diagnose a
    #: noisy-neighbor incident.  None on single-model fleets.
    tenant: Optional[str] = None
    model: Optional[str] = None
    model_version: Optional[str] = None

    @classmethod
    def mint(cls, deadline_s: Optional[float] = None,
             sampled: bool = True) -> "TraceContext":
        """A fresh root context (trace id from the OS entropy pool —
        never the seeded training streams, which checkpoint/replay)."""
        return cls(trace_id=os.urandom(8).hex(), span_id=1,
                   deadline_s=deadline_s, sampled=sampled)

    def child(self, span_id: int, remaining_s: Optional[float] = None,
              attempt: Optional[int] = None,
              phase: Optional[str] = None) -> "TraceContext":
        """Fork for one dispatch attempt: same trace, new parent span,
        the budget that remains NOW."""
        return TraceContext(
            trace_id=self.trace_id, span_id=int(span_id),
            deadline_s=(self.deadline_s if remaining_s is None
                        else remaining_s),
            sampled=self.sampled,
            attempt=self.attempt if attempt is None else int(attempt),
            phase=self.phase if phase is None else phase,
            tenant=self.tenant, model=self.model,
            model_version=self.model_version)

    def to_wire(self) -> dict:
        """JSON-serializable wire form (submit kwargs, handoff-blob
        extras)."""
        return {
            "trace_id": self.trace_id, "span_id": int(self.span_id),
            "deadline_s": self.deadline_s, "sampled": bool(self.sampled),
            "attempt": int(self.attempt), "phase": self.phase,
            "tenant": self.tenant, "model": self.model,
            "model_version": self.model_version,
        }

    @classmethod
    def from_wire(cls, wire) -> Optional["TraceContext"]:
        """Parse a wire dict (or pass through a TraceContext); None on
        anything unusable — a malformed context must degrade to
        untraced, never fail the request."""
        if wire is None:
            return None
        if isinstance(wire, TraceContext):
            return wire
        try:
            return cls(
                trace_id=str(wire["trace_id"]),
                span_id=int(wire.get("span_id", 1)),
                deadline_s=wire.get("deadline_s"),
                sampled=bool(wire.get("sampled", True)),
                attempt=int(wire.get("attempt", 0)),
                phase=wire.get("phase"),
                tenant=wire.get("tenant"),
                model=wire.get("model"),
                model_version=wire.get("model_version"))
        except (TypeError, KeyError, ValueError):
            return None


class TailSampler:
    """Tail-based retention policy, decided at request completion.

    Always keeps: non-OK outcomes (errors, sheds, deadline expiries),
    retried requests, hedged requests, and requests whose latency
    reached the current p99.  OK traffic under the tail is kept
    probabilistically under ``keep_per_s`` (a token bucket — the
    budget bounds stitch/storage cost, not observability of trouble).
    """

    def __init__(self, keep_per_s: float = 10.0, burst: float = 20.0,
                 ok_prob: float = 1.0,
                 clock: Callable[[], float] = time.monotonic,
                 seed: int = 0):
        self.keep_per_s = float(keep_per_s)
        self.burst = max(1.0, float(burst))
        self.ok_prob = float(ok_prob)
        self._clock = clock
        self._tokens = self.burst
        self._t_last = clock()
        # explicitly seeded local generator (never the global stream —
        # the determinism lint, and sampling must not perturb training)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.kept: Dict[str, int] = {}
        self.dropped = 0

    def _take_token(self) -> bool:
        now = self._clock()
        self._tokens = min(
            self.burst,
            self._tokens + (now - self._t_last) * self.keep_per_s)
        self._t_last = now
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False

    def keep(self, *, ok: bool, retried: bool = False,
             hedged: bool = False, latency_s: float = 0.0,
             p99_s: Optional[float] = None) -> Optional[str]:
        """The keep reason, or None to drop.  Reasons: ``error`` /
        ``retry`` / ``hedge`` / ``p99`` / ``budget``."""
        with self._lock:
            reason = None
            if not ok:
                reason = "error"
            elif retried:
                reason = "retry"
            elif hedged:
                reason = "hedge"
            elif p99_s is not None and p99_s > 0 \
                    and latency_s >= p99_s:
                reason = "p99"
            elif self._rng.random() < self.ok_prob \
                    and self._take_token():
                reason = "budget"
            if reason is None:
                self.dropped += 1
            else:
                self.kept[reason] = self.kept.get(reason, 0) + 1
            return reason

    def snapshot(self) -> dict:
        with self._lock:
            return {"kept": dict(sorted(self.kept.items())),
                    "kept_total": sum(self.kept.values()),
                    "dropped": self.dropped,
                    "keep_per_s": self.keep_per_s}
