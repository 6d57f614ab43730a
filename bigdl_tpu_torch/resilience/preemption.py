"""Graceful preemption: checkpoint at the next step boundary, exit clean.

TPU VMs (and any spot/managed capacity) are preempted with a SIGTERM
and a short grace period; Ctrl-C during an interactive run is the same
problem.  Killing a trainer mid-step loses everything since the last
checkpoint trigger; catching the signal mid-step can't safely
checkpoint either (device arrays are in flight).  The handler here just
RECORDS the request; the training loops poll :meth:`should_stop` at
each step boundary, write one final checkpoint with the live state, and
return the model — a subsequent run with the same checkpoint path
resumes via ``resume_from_checkpoint``.

A second SIGINT while a stop is already pending raises
``KeyboardInterrupt`` immediately — an operator hammering Ctrl-C wants
out now, not after the checkpoint.
"""
from __future__ import annotations

import logging
import signal
import threading

log = logging.getLogger("bigdl_tpu")

# process-wide request flag: lets tests (and embedders without signal
# access, e.g. non-main threads) request a graceful stop directly
_GLOBAL_REQUEST = threading.Event()


def request_preemption():
    """Programmatically request a graceful stop — the same effect as
    delivering SIGTERM to the process."""
    _GLOBAL_REQUEST.set()


class PreemptionHandler:
    """Context manager installing SIGTERM/SIGINT handlers for one
    training run.  Degrades gracefully off the main thread (where
    ``signal.signal`` is unavailable): the process-wide
    :func:`request_preemption` flag still works."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT),
                 on_request=None):
        self.signals = tuple(signals)
        self._old = {}
        self._requested = False
        self.installed = False
        #: optional callback fired the instant a stop is requested
        #: (from the signal handler or request()) — lets embedders
        #: that poll between steps ALSO react immediately, e.g. the
        #: serving readiness probe flipping unready on SIGTERM before
        #: the worker reaches its next batch boundary.  Must be
        #: async-signal-safe-ish: set a flag, don't do work.
        self._on_request = on_request

    # ------------------------------------------------------------------
    def _notify(self):
        if self._on_request is None:
            return
        try:
            self._on_request()
        except Exception:  # a broken callback must not mask the signal
            log.exception("preemption on_request callback failed")

    def _on_signal(self, signum, frame):
        if self._requested and signum == signal.SIGINT:
            raise KeyboardInterrupt
        self._requested = True
        log.warning("received signal %d — will checkpoint at the next "
                    "step boundary and exit resumable", signum)
        self._notify()

    @property
    def should_stop(self) -> bool:
        return self._requested or _GLOBAL_REQUEST.is_set()

    def request(self):
        self._requested = True
        self._notify()

    # ------------------------------------------------------------------
    def __enter__(self):
        _GLOBAL_REQUEST.clear()  # a fresh run starts unpreempted
        try:
            for s in self.signals:
                self._old[s] = signal.signal(s, self._on_signal)
            self.installed = True
        except ValueError:  # not the main thread
            self._old.clear()
            self.installed = False
        return self

    def __exit__(self, *exc):
        for s, h in self._old.items():
            try:
                signal.signal(s, h)
            except ValueError:
                pass
        self._old.clear()
        self.installed = False
        return False
