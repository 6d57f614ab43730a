"""Status taxonomy + per-request future.

Every admitted (or rejected) request resolves to exactly one
:class:`ServeResult`; the server never drops a request silently and
never leaves a caller blocked forever — load shedding, deadline
expiry, breaker rejection, and drain cancellation are all *typed*
outcomes the caller can branch on, mirroring how
``resilience.retry.classify_error`` makes training failures explicit
instead of letting them crash the caller.
"""
from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, field
from typing import Any, Optional


class Status(enum.Enum):
    OK = "ok"
    #: deadline elapsed before the request reached a device (or at
    #: admission, when it was already expired on arrival)
    DEADLINE_EXCEEDED = "deadline_exceeded"
    #: admission-control rejection: the bounded queue is full (shed)
    OVERLOADED = "overloaded"
    #: the server cannot take the request right now: circuit breaker
    #: open, server draining, or not started
    UNAVAILABLE = "unavailable"
    #: the compiled step raised; the error string carries the cause
    INTERNAL_ERROR = "internal_error"
    #: the server was hard-stopped with the request still queued
    CANCELLED = "cancelled"
    #: the request named a model/version no replica advertises (or the
    #: registry entry vanished mid-flight) — resolved typed at
    #: admission, never retried, never surfaced as INTERNAL_ERROR
    NOT_FOUND = "not_found"


@dataclass
class ServeResult:
    """Terminal outcome of one request."""
    status: Status
    output: Any = None          # per-request output row(s); OK only
    error: Optional[str] = None
    #: submit → resolve wall time (seconds)
    latency_s: float = 0.0
    #: portion of latency spent queued before batch formation
    queued_s: float = 0.0
    #: padded bucket the request ran in (OK/INTERNAL_ERROR only)
    bucket: Optional[int] = None
    #: distributed-trace id when request tracing is enabled (look the
    #: stitched timeline up via the router's RequestTracer / exemplars)
    trace_id: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.status is Status.OK


class ServeFuture:
    """Single-assignment result slot handed back by ``submit``.

    ``result(timeout)`` blocks until the server resolves the request;
    a ``timeout`` raises ``TimeoutError`` rather than returning a
    placeholder, so a hung server is loud — but under the server's
    contract every admitted request is resolved even on drain, stop,
    or breaker trip.  ``add_done_callback`` lets the fleet router wait
    on several replicas' futures at once (hedging) without polling."""

    __slots__ = ("_event", "_result", "_callbacks", "_cb_lock")

    def __init__(self):
        self._event = threading.Event()
        self._result: Optional[ServeResult] = None
        self._callbacks = []
        self._cb_lock = threading.Lock()

    def done(self) -> bool:
        return self._event.is_set()

    def _resolve(self, result: ServeResult):
        with self._cb_lock:
            if self._event.is_set():  # first resolution wins
                return
            self._result = result
            self._event.set()
            callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            try:
                cb(self)
            except Exception:  # a broken observer must not break resolve
                pass

    def add_done_callback(self, fn):
        """Call ``fn(self)`` when the future resolves (immediately if it
        already has).  Callback exceptions are swallowed — resolution
        must never fail because an observer raised."""
        with self._cb_lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        try:
            fn(self)
        except Exception:
            pass

    def result(self, timeout: Optional[float] = None) -> ServeResult:
        if not self._event.wait(timeout):
            raise TimeoutError("request not resolved within "
                               f"{timeout}s")
        return self._result


@dataclass
class Request:
    """Internal queue entry (kind: ``"classify"``, ``"generate"``, or
    the paged ``"prefill"`` / ``"decode"``)."""
    kind: str
    payload: Any
    future: ServeFuture
    submitted_at: float
    #: absolute monotonic deadline, or None
    deadline: Optional[float] = None
    #: generate-path options (max_new, eos_id, pad_id)
    opts: tuple = field(default_factory=tuple)
    #: distributed-trace context (telemetry.trace_context.TraceContext)
    #: propagated from the router, or None when untraced
    trace: Optional[object] = None

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now >= self.deadline
