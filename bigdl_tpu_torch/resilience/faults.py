"""Deterministic fault injection for recovery tests (counterpart of
``bigdl_tpu/resilience/faults.py``, trimmed to the injectors the
training, checkpoint and serving paths of the port consult).

Every injector fires at an explicit, deterministic point (record index,
byte offset, call count) and records that it fired, so a recovery test
can assert both that the fault happened and that the run rode through
it:

* data-plane transformers: :class:`ExceptionTransformer` (a driver
  exception), :class:`NaNInjector` (NaN features, so the gradient guard
  skips the step), :class:`ScaleInjector` (scaled features, a loss
  spike), :class:`PreemptTransformer` (a graceful-stop request);
* file level: :func:`bit_flip`, :func:`truncate` corrupt a checkpoint;
  :func:`io_faults` fails writes through ``check_io_fault`` (called by
  ``utils.file_io.save_bytes``);
* serving: :func:`serving_step_failures`, :func:`serving_step_latency`
  reach every batch step and the hot-swap canary through
  ``check_serving_fault``; :func:`poison_params` makes a NaN copy of a
  param tree.

The elastic, fleet, loop, migration and tenant injectors of the JAX
module are not ported yet.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..dataset.sample import Sample
from ..dataset.transformer import Transformer
from ..utils.tree import tree_map

# ---------------------------------------------------------------------------
# data-plane injectors (Transformer stages)
# ---------------------------------------------------------------------------


class ExceptionTransformer(Transformer):
    """Raises once when the ``fail_at``-th record passes through;
    ``fired`` records that the fault triggered."""

    def __init__(self, fail_at: int,
                 exc: Callable[[], BaseException] = None):
        self.fail_at = fail_at
        self.count = 0
        self.fired = False
        self._exc = exc or (lambda: RuntimeError("injected failure"))

    def apply(self, it):
        for item in it:
            self.count += 1
            if self.count == self.fail_at and not self.fired:
                self.fired = True
                raise self._exc()
            yield item


class NaNInjector(Transformer):
    """Replaces the features of records [``at``, ``at + n``) with NaN,
    once per run, so the step's loss and gradients go NaN."""

    def __init__(self, at: int, n: int = 1):
        self.at = at
        self.n = n
        self.count = 0
        self.fired = 0

    def apply(self, it):
        for item in it:
            self.count += 1
            if (self.at <= self.count < self.at + self.n
                    and self.fired < self.n):
                self.fired += 1
                f = np.full_like(np.asarray(item.feature, np.float32),
                                 np.nan)
                item = Sample(f, item.label)
            yield item


class ScaleInjector(Transformer):
    """Scales the features of records [``at``, ``at + n``) by ``scale``,
    once per run: the loss jumps far above its running average."""

    def __init__(self, at: int, n: int, scale: float):
        self.at = at
        self.n = n
        self.scale = float(scale)
        self.count = 0
        self.fired = 0

    def apply(self, it):
        for item in it:
            self.count += 1
            if (self.at <= self.count < self.at + self.n
                    and self.fired < self.n):
                self.fired += 1
                f = np.asarray(item.feature, np.float32) * self.scale
                item = Sample(f, item.label)
            yield item


class PreemptTransformer(Transformer):
    """Requests a graceful preemption (the SIGTERM path without the
    signal) when the ``at``-th record passes through."""

    def __init__(self, at: int):
        self.at = at
        self.count = 0
        self.fired = False

    def apply(self, it):
        from .preemption import request_preemption

        for item in it:
            self.count += 1
            if self.count == self.at and not self.fired:
                self.fired = True
                request_preemption()
            yield item


# ---------------------------------------------------------------------------
# checkpoint corruption (file level)
# ---------------------------------------------------------------------------

def bit_flip(path: str, offset: Optional[int] = None, seed: int = 0):
    """Flip one byte's bits at ``offset`` (mid-file by default) — the
    silent corruption crc32c must catch."""
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"{path} is empty — nothing to flip")
    if offset is None:
        offset = (size // 2 + seed) % size
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))
    return offset


def truncate(path: str, keep_fraction: float = 0.5):
    """Truncate a file to ``keep_fraction`` of its size — the torn write
    or full disk."""
    keep = int(os.path.getsize(path) * keep_fraction)
    with open(path, "r+b") as f:
        f.truncate(keep)
    return keep


# ---------------------------------------------------------------------------
# I/O faults
# ---------------------------------------------------------------------------

_IO_LOCK = threading.Lock()
_IO_FAULTS: list = []  # [dict(substr, remaining, exc_type)]


def check_io_fault(path: str):
    """Called before each checkpoint write; raises the injected error
    while its budget lasts.  Free when nothing is registered."""
    if not _IO_FAULTS:
        return
    with _IO_LOCK:
        for f in _IO_FAULTS:
            if f["substr"] in path and f["remaining"] > 0:
                f["remaining"] -= 1
                raise f["exc_type"](
                    f"injected transient I/O error on {path} "
                    f"({f['remaining']} left)")


@contextlib.contextmanager
def io_faults(substr: str, times: int = 1, exc_type=OSError):
    """Fail the next ``times`` writes of any path containing
    ``substr`` with ``exc_type``."""
    entry = {"substr": substr, "remaining": int(times),
             "exc_type": exc_type}
    with _IO_LOCK:
        _IO_FAULTS.append(entry)
    try:
        yield entry
    finally:
        with _IO_LOCK:
            _IO_FAULTS.remove(entry)


# ---------------------------------------------------------------------------
# serving faults
# ---------------------------------------------------------------------------
# The serving worker calls check_serving_fault() before each batch step
# (and the hot-swap canary before its forward), so the breaker, deadline
# and swap behaviours are testable deterministically on the CPU.

_SERVING_LOCK = threading.Lock()
_SERVING_FAULTS: list = []


def check_serving_fault(server: Optional[str] = None):
    """Apply the injected latency, then raise the injected failure while
    its budget lasts.  An entry naming a ``server`` fires only for that
    server; unscoped entries fire for every one.  Free when nothing is
    registered."""
    if not _SERVING_FAULTS:
        return
    delay = 0.0
    boom = None
    with _SERVING_LOCK:
        for f in _SERVING_FAULTS:
            if f["remaining"] <= 0:
                continue
            if f.get("server") is not None and f["server"] != server:
                continue
            if f["kind"] == "latency":
                f["remaining"] -= 1
                f["fired"] += 1
                delay += f["seconds"]
            elif boom is None:
                f["remaining"] -= 1
                f["fired"] += 1
                boom = f["exc_type"](
                    f"injected serving step failure "
                    f"({f['remaining']} left)")
    if delay > 0:
        time.sleep(delay)
    if boom is not None:
        raise boom


@contextlib.contextmanager
def _serving_fault(entry: dict):
    with _SERVING_LOCK:
        _SERVING_FAULTS.append(entry)
    try:
        yield entry
    finally:
        with _SERVING_LOCK:
            _SERVING_FAULTS.remove(entry)


def serving_step_failures(times: int = 1, exc_type=RuntimeError,
                          server: Optional[str] = None):
    """Fail the next ``times`` serving batch steps with ``exc_type`` (a
    retryable type counts toward the breaker's threshold, a fatal one
    trips it at once).  ``server`` scopes the fault to one name."""
    return _serving_fault({"kind": "fail", "remaining": int(times),
                           "exc_type": exc_type, "fired": 0,
                           "server": None if server is None
                           else str(server)})


def serving_step_latency(seconds: float, times: int = 1 << 30,
                         server: Optional[str] = None):
    """Add ``seconds`` of host latency to the next ``times`` serving
    batch steps."""
    return _serving_fault({"kind": "latency", "remaining": int(times),
                           "seconds": float(seconds), "fired": 0,
                           "server": None if server is None
                           else str(server)})


def poison_params(tree):
    """A NaN copy of a param tree (every float leaf) — the hot-swap
    canary must refuse it."""
    def poison(leaf):
        t = torch.as_tensor(leaf)
        return torch.full_like(t, float("nan")) if t.is_floating_point() \
            else t.clone()

    return tree_map(poison, tree)
