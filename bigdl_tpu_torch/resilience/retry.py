"""RetryPolicy — exponential backoff, jitter, error classification.

Replaces the reference's fixed retry-count-in-a-time-window loop
(DistriOptimizer.scala:750-752, mirrored by the old ``_with_retry``):
same windowed attempt accounting, plus

* exponential backoff with deterministic jitter between attempts — an
  immediate hot retry against a struggling filesystem or a flapping
  coordinator just loses another attempt;
* retryable-vs-fatal classification — an OOM or a shape error will
  fail identically on every replay from the same checkpoint, so
  burning the retry budget on it only delays the real report.

The ``bigdl.failure.retryTimes`` / ``bigdl.failure.retryTimeInterval``
properties keep their exact meaning as compat aliases; the backoff and
jitter knobs are new (``bigdl.failure.backoffBase`` /
``backoffMax`` / ``jitter``).
"""
from __future__ import annotations

import logging
import os
import random
import time
from typing import Callable, Optional, Sequence, Tuple, Type

log = logging.getLogger("bigdl_tpu")


def get_property(name: str, default=None):
    """``bigdl.*`` system properties become env vars: bigdl.foo → BIGDL_FOO
    (the JAX package reads them through ``utils/engine.py``)."""
    env = name.replace(".", "_").upper()
    return os.environ.get(env, os.environ.get(name, default))


class FatalTrainingError(Exception):
    """Raise (or wrap) to mark an error as not-retryable regardless of
    the policy's type lists."""


class LossSpikeError(RuntimeError):
    """Training loss diverged (K consecutive spikes).  Retryable: the
    retry loop answers it by restoring the last good checkpoint."""


# Errors that will reproduce identically on a replay from the same
# checkpoint — retrying them burns the budget without new information.
DEFAULT_FATAL_TYPES: Tuple[Type[BaseException], ...] = (
    FatalTrainingError, MemoryError, NotImplementedError, SyntaxError,
)


def classify_error(exc: BaseException,
                   fatal_types: Sequence[Type[BaseException]]
                   = DEFAULT_FATAL_TYPES) -> str:
    """``"fatal"`` or ``"retryable"``.

    Control-flow exceptions (KeyboardInterrupt/SystemExit) are fatal —
    the user asked to stop.  Beyond the explicit fatal list everything
    defaults to retryable, preserving the reference loop's semantics
    (it retried any Exception)."""
    if isinstance(exc, (KeyboardInterrupt, SystemExit, GeneratorExit)):
        return "fatal"
    if isinstance(exc, tuple(fatal_types)):
        return "fatal"
    return "retryable"


class RetryPolicy:
    """Windowed retry with exponential backoff + jitter.

    ``max_retries`` attempts are allowed per ``window`` seconds (the
    reference's retryTimes-in-retryTimeInterval accounting: the counter
    resets when the window has elapsed since the last reset).  Delay
    before attempt ``i`` (1-based) is::

        min(backoff_base * 2**(i-1), backoff_max) * (1 + jitter*u)

    with ``u`` drawn uniformly from [-1, 1) by a deterministically
    seeded generator, so schedules reproduce run-to-run.
    """

    def __init__(self, max_retries: int = 5, window: float = 120.0,
                 backoff_base: float = 0.1, backoff_max: float = 30.0,
                 jitter: float = 0.1,
                 fatal_types: Sequence[Type[BaseException]]
                 = DEFAULT_FATAL_TYPES,
                 sleep: Callable[[float], None] = time.sleep,
                 seed: int = 0):
        self.max_retries = int(max_retries)
        self.window = float(window)
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)
        self.jitter = float(jitter)
        self.fatal_types = tuple(fatal_types)
        self._sleep = sleep
        self._seed = seed
        self._rng = random.Random(seed)

    @classmethod
    def from_properties(cls, prefix: str = "bigdl.failure",
                        **overrides) -> "RetryPolicy":
        """Build from ``<prefix>.*`` properties (compat aliases
        ``retryTimes``/``retryTimeInterval`` plus the new backoff
        knobs); explicit ``overrides`` win.  The training loop reads
        ``bigdl.failure.*``; the serving path passes
        ``prefix="bigdl.serving"`` so its classification/backoff knobs
        tune independently of the trainer's."""
        kw = dict(
            max_retries=int(get_property(f"{prefix}.retryTimes", 5)),
            window=float(get_property(f"{prefix}.retryTimeInterval",
                                      120)),
            backoff_base=float(get_property(f"{prefix}.backoffBase",
                                            0.1)),
            backoff_max=float(get_property(f"{prefix}.backoffMax", 30)),
            jitter=float(get_property(f"{prefix}.jitter", 0.1)),
        )
        kw.update(overrides)
        return cls(**kw)

    # ------------------------------------------------------------------
    def classify(self, exc: BaseException) -> str:
        return classify_error(exc, self.fatal_types)

    def delay(self, attempt: int) -> float:
        """Jittered backoff before retry ``attempt`` (1-based).
        Consumes the policy's deterministic jitter stream."""
        base = min(self.backoff_base * (2.0 ** (attempt - 1)),
                   self.backoff_max)
        return max(0.0, base * (1.0 + self.jitter
                                * (2.0 * self._rng.random() - 1.0)))

    def schedule(self, n: int) -> list:
        """The first ``n`` delays a fresh copy of this policy would
        sleep (does not consume this policy's jitter stream)."""
        twin = RetryPolicy(self.max_retries, self.window,
                           self.backoff_base, self.backoff_max,
                           self.jitter, self.fatal_types, self._sleep,
                           seed=self._seed)
        return [twin.delay(i) for i in range(1, n + 1)]

    # ------------------------------------------------------------------
    def run(self, fn: Callable, on_retry: Optional[Callable] = None):
        """Call ``fn()`` until it returns; on a retryable error sleep
        the backoff, call ``on_retry(exc, attempt)`` (the restore hook),
        and try again.  Fatal errors and exhausted budgets re-raise."""
        attempts = 0
        window_start = time.time()
        while True:
            try:
                return fn()
            except BaseException as e:
                if self.classify(e) == "fatal":
                    raise
                if time.time() - window_start > self.window:
                    attempts = 0
                    window_start = time.time()
                attempts += 1
                if attempts > self.max_retries:
                    raise
                from ..telemetry.registry import default_registry

                default_registry().counter(
                    "bigdl_retry_attempts_total",
                    "retryable failures answered with a backoff "
                    "retry").inc()
                d = self.delay(attempts)
                log.warning(
                    "Error during training: %s — retry %d/%d after %.2fs "
                    "backoff", e, attempts, self.max_retries, d)
                if d > 0:
                    self._sleep(d)
                if on_retry is not None:
                    on_retry(e, attempts)
