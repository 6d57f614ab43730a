"""Circuit breaker around the compiled serving step.

States (the classic taxonomy):

* **closed** — requests flow; consecutive failures are counted.
* **open** — tripped: every batch is rejected fast with
  ``Status.UNAVAILABLE`` (degrade, don't crash) until
  ``reset_timeout`` elapses.
* **half-open** — after the timeout, ONE probe batch is admitted to
  test recovery: success closes the breaker, failure re-opens it (and
  restarts the timeout).

Failure classification rides :class:`resilience.retry.RetryPolicy`:
*fatal* errors (the step will fail identically on every replay —
shape errors, OOM) trip the breaker immediately; *retryable* ones
(flaky device, transient runtime error) count toward
``failure_threshold`` first.  The clock is injectable so tests drive
open→half-open transitions deterministically.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


def _count_transition(to_state: str, owner: Optional[str] = None):
    """Breaker state transitions land in the process-wide telemetry
    registry, labeled by destination state.  ``owner`` names the
    replica the breaker guards (the JAX package also journals it; the
    port has no change journal yet)."""
    from ..telemetry.registry import default_registry

    default_registry().counter(
        "bigdl_breaker_transitions_total",
        "circuit breaker state transitions",
        labels=("to",)).labels(to=to_state).inc()

#: acquire() verdicts
ADMIT = "admit"
PROBE = "probe"
REJECT = "reject"


class CircuitBreaker:
    def __init__(self, failure_threshold: int = 3,
                 reset_timeout: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout = float(reset_timeout)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_in_flight = False
        self.trips = 0        # closed/half-open -> open transitions
        self.recoveries = 0   # half-open probe successes
        #: the replica this breaker guards (the router stamps it so
        #: journal events carry a replica scope); None = anonymous
        self.owner: Optional[str] = None

    # ------------------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def acquire(self) -> str:
        """Gate one batch: ``ADMIT`` (closed), ``PROBE`` (half-open,
        single in-flight probe granted), or ``REJECT`` (open, or a
        probe is already out)."""
        with self._lock:
            if self._state == CLOSED:
                return ADMIT
            if self._state == OPEN:
                if self._clock() - self._opened_at < self.reset_timeout:
                    return REJECT
                self._state = HALF_OPEN
                self._probe_in_flight = False
                _count_transition("half_open", self.owner)
            # half-open: one probe at a time
            if self._probe_in_flight:
                return REJECT
            self._probe_in_flight = True
            return PROBE

    def record_success(self):
        with self._lock:
            if self._state == HALF_OPEN:
                self.recoveries += 1
                _count_transition("closed", self.owner)
            self._state = CLOSED
            self._consecutive_failures = 0
            self._probe_in_flight = False

    def record_failure(self, fatal: bool = False):
        """One step failure.  A failed half-open probe re-opens
        immediately; in closed state, ``fatal`` (or reaching
        ``failure_threshold`` consecutive retryables) trips."""
        with self._lock:
            self._consecutive_failures += 1
            trip = (fatal or self._state == HALF_OPEN
                    or self._consecutive_failures >= self.failure_threshold)
            self._probe_in_flight = False
            if trip and self._state != OPEN:
                self._state = OPEN
                self._opened_at = self._clock()
                self.trips += 1
                _count_transition("open", self.owner)

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self._consecutive_failures,
                "trips": self.trips,
                "recoveries": self.recoveries,
            }
