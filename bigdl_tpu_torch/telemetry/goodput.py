"""Goodput ledger — classify every second of run wall clock.

"Where did the last hour of cluster time go?" is the question the
BigDL paper's iteration analysis answers with per-phase accumulators;
at production scale the honest unit is not the step but the **run**:
a trainer that steps fast but spends half its life recompiling after
evictions has 50% goodput, and nothing in a step-time histogram says
so.  The ledger classifies run wall clock into exactly one of:

* ``productive``  — compiled steps doing real optimization work
* ``compile``     — the first step of every attempt (kernel builds,
  the work count)
* ``data_stall``  — the device waited on the input pipeline
* ``checkpoint``  — writing / restoring state
* ``recovery``    — fault detected → first post-restore productive
  step (retry backoff, rendezvous, re-shard all land here)
* ``idle``        — the remainder (validation, logging, host python)

``accounted_fraction`` is attributed ÷ wall **including idle**: idle
is a named bucket, not an excuse, so the ledger always explains where
the time went — the acceptance bar for a merged cluster snapshot is
>= 99% accounted.  The clock is injectable; tests drive it by hand.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

__all__ = ["GOODPUT_CATEGORIES", "GoodputLedger"]

GOODPUT_CATEGORIES = (
    "productive", "compile", "data_stall", "checkpoint", "recovery",
    "idle",
)


class GoodputLedger:
    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._start: Optional[float] = None
        self._seconds: Dict[str, float] = {
            c: 0.0 for c in GOODPUT_CATEGORIES if c != "idle"}
        self._recovery_since: Optional[float] = None
        self.recovery_windows = 0

    # -- lifecycle ------------------------------------------------------
    def start(self):
        """Start (or continue) the run clock — idempotent, so every
        retry attempt may call it and only the first one counts."""
        with self._lock:
            if self._start is None:
                self._start = self._clock()
        return self

    @property
    def started(self) -> bool:
        with self._lock:
            return self._start is not None

    # -- attribution ----------------------------------------------------
    def add(self, category: str, seconds: float):
        if category == "idle":
            raise ValueError("idle is derived (wall - attributed), "
                             "never added")
        if category not in self._seconds:
            raise ValueError(f"unknown goodput category {category!r}; "
                             f"one of {GOODPUT_CATEGORIES}")
        with self._lock:
            if self._start is None:
                self._start = self._clock()
            self._seconds[category] += max(0.0, float(seconds))

    def recovery_begin(self):
        """A fault was detected: wall clock from now until
        :meth:`recovery_end` is recovery, whatever python it runs."""
        with self._lock:
            if self._start is None:
                self._start = self._clock()
            if self._recovery_since is None:
                self._recovery_since = self._clock()
                self.recovery_windows += 1

    def recovery_end(self, exclude: float = 0.0) -> float:
        """First productive work after a fault: close the window.
        ``exclude`` trims seconds off the tail — the caller learns of
        the recovery's end only AFTER the first post-restore step
        completed, and that step's own duration is attributed as
        compile/productive, not recovery (no double counting).
        Returns the window's attributed seconds (0.0 when none was
        open)."""
        with self._lock:
            if self._recovery_since is None:
                return 0.0
            dt = max(0.0, self._clock() - self._recovery_since
                     - max(0.0, float(exclude)))
            self._seconds["recovery"] += dt
            self._recovery_since = None
            return dt

    @property
    def in_recovery(self) -> bool:
        with self._lock:
            return self._recovery_since is not None

    # -- reporting ------------------------------------------------------
    def snapshot(self) -> dict:
        """Wall clock, per-category seconds (idle = the unattributed
        remainder, an open recovery window counted live), productive
        and accounted fractions."""
        with self._lock:
            now = self._clock()
            wall = (now - self._start) if self._start is not None else 0.0
            secs = dict(self._seconds)
            if self._recovery_since is not None:
                secs["recovery"] += now - self._recovery_since
            attributed = sum(secs.values())
            secs["idle"] = max(0.0, wall - attributed)
            total = attributed + secs["idle"]
            # < 1.0 only when attribution OVERLAPPED (sum > wall); the
            # drivers attribute disjoint segments, so ~1.0
            accounted = min(1.0, wall / total) if total > 0 else 1.0
            return {
                "wall_s": wall,
                "seconds": secs,
                "productive_fraction": (secs["productive"] / wall
                                        if wall > 0 else 0.0),
                "accounted_fraction": accounted,
            }

    @staticmethod
    def merge_snapshots(snaps) -> dict:
        """Cluster view: per-category seconds and wall clock summed
        over host snapshots (host-seconds, the unit cluster goodput is
        honestly measured in)."""
        snaps = list(snaps)
        secs = {c: 0.0 for c in GOODPUT_CATEGORIES}
        wall = 0.0
        for s in snaps:
            wall += float(s.get("wall_s", 0.0))
            for c, v in (s.get("seconds") or {}).items():
                secs[c] = secs.get(c, 0.0) + float(v)
        attributed = sum(secs.values())
        return {
            "hosts": len(snaps),
            "wall_s": wall,
            "seconds": secs,
            "productive_fraction": (secs["productive"] / wall
                                    if wall > 0 else 0.0),
            "accounted_fraction": (min(1.0, wall / attributed)
                                   if attributed > 0 else 1.0),
        }
