"""Background publisher — cross-host KV publishing off the step path.

Elastic telemetry snapshots and SDC-vote checksums ride the KV
transport (``FileKV`` writes real files; a production etcd/redis put is
a network round trip).  Doing those puts inline means transport
latency lands directly in step wall clock.  This publisher moves them
to a single daemon thread with three properties the elastic layer
needs:

* **never blocks the caller** — the work deque is bounded; when full,
  the oldest coalescible task is dropped (telemetry snapshots are
  "newest wins" by contract, so dropping a stale one loses nothing);
* **incarnation-keyed staleness discard** — each task may carry the
  incarnation it was created under; at execution time a task from a
  membership that no longer exists is discarded instead of published
  (the same rule the ``tm/<incarnation>/<host>`` keyspace encodes);
* **coalescing** — tasks sharing a ``key`` replace their queued
  predecessor (one pending telemetry snapshot, not a backlog), while
  ``urgent`` tasks (vote checksums — a synchronous round is waiting on
  them) jump the queue.

:meth:`BackgroundPublisher.drain` is the barrier for readers that need
their own freshest payload visible before collecting (the leader's
``cluster_snapshot``).
"""
from __future__ import annotations

import logging
import threading
from collections import deque
from typing import Callable, Optional

log = logging.getLogger("bigdl_tpu")

__all__ = ["BackgroundPublisher"]


class _Task:
    __slots__ = ("fn", "incarnation", "key")

    def __init__(self, fn, incarnation, key):
        self.fn = fn
        self.incarnation = incarnation
        self.key = key


class BackgroundPublisher:
    def __init__(self, incarnation_of: Optional[Callable[[], int]] = None,
                 capacity: int = 16, name: str = "bigdl-publisher"):
        self._incarnation_of = incarnation_of
        self.capacity = max(1, int(capacity))
        self._name = name
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._dq: deque = deque()
        self._in_flight = 0
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        # -- counters ---------------------------------------------------
        self.published = 0
        self.discarded_stale = 0
        self.coalesced = 0
        self.dropped = 0
        self.errors = 0

    # -- internals -------------------------------------------------------
    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name=self._name)
            self._thread.start()

    def _run(self):
        while True:
            with self._cv:
                while not self._dq and not self._closed:
                    self._cv.wait()
                if not self._dq and self._closed:
                    return
                task = self._dq.popleft()
                self._in_flight += 1
            try:
                stale = (task.incarnation is not None
                         and self._incarnation_of is not None
                         and self._incarnation_of() != task.incarnation)
                if stale:
                    with self._cv:
                        self.discarded_stale += 1
                else:
                    task.fn()
                    with self._cv:
                        self.published += 1
            except Exception:
                with self._cv:
                    self.errors += 1
                log.warning("background publish failed", exc_info=True)
            finally:
                with self._cv:
                    self._in_flight -= 1
                    self._cv.notify_all()

    # -- API -------------------------------------------------------------
    def submit(self, fn: Callable[[], None], *,
               incarnation: Optional[int] = None,
               key: Optional[str] = None, urgent: bool = False) -> bool:
        """Queue ``fn`` for background execution; returns False when
        the publisher is closed (the caller should fall back to a
        synchronous publish).  Never blocks."""
        task = _Task(fn, incarnation, key)
        with self._cv:
            if self._closed:
                return False
            if key is not None:
                for old in list(self._dq):
                    if old.key == key:
                        self._dq.remove(old)
                        self.coalesced += 1
                        break
            if len(self._dq) >= self.capacity:
                # bounded: shed the oldest non-urgent backlog entry
                self._dq.popleft()
                self.dropped += 1
            if urgent:
                self._dq.appendleft(task)
            else:
                self._dq.append(task)
            self._cv.notify_all()
        self._ensure_thread()
        return True

    def drain(self, timeout: Optional[float] = 5.0) -> bool:
        """Block until the queue is empty and nothing is in flight —
        the freshest submitted payload is then visible to collectors.
        Returns False on timeout."""
        import time

        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._dq or self._in_flight:
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._cv.wait(remaining if remaining is not None else 0.5)
        return True

    def close(self, timeout: float = 5.0):
        self.drain(timeout=timeout)
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=2.0)

    @property
    def backlog(self) -> int:
        with self._cv:
            return len(self._dq) + self._in_flight
