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
  param tree;
* fleet: :func:`kill_replica`, :func:`delay_replica`,
  :func:`partition_kv` reach each replica's heartbeat pump through
  ``check_fleet_fault``;
* the continuous loop: :func:`poison_candidate`,
  :func:`loop_loss_divergence` through ``check_loop_fault``;
* tenants: :func:`tenant_flood` (admission) and
  :func:`unregister_model_mid_flight` (the model registry).

Every injector armed as a context records ``chaos_inject`` and
``chaos_clear`` in the change journal (``ground_truth=True``).  The
elastic, integrity and migration injectors of the JAX module are not
ported yet.
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


def _journal_chaos(event: str, entry: dict):
    """Record a chaos injector's arm/disarm into the change journal,
    tagged ``ground_truth=True`` — the scoreable cause benches judge
    blame rankings against (docs/observability.md "Incidents").  Lazy
    import keeps faults importable independent of telemetry."""
    from ..telemetry.events import record_change

    detail = " ".join(
        f"{k}={entry[k]}" for k in ("kind", "substr", "seconds",
                                    "rps", "at_step", "scale")
        if entry.get(k) is not None)
    record_change(event, detail, ground_truth=True,
                  source="resilience.faults",
                  host=entry.get("host"),
                  replica=entry.get("replica") or entry.get("server"),
                  tenant=entry.get("tenant"),
                  model=entry.get("model"),
                  table=entry.get("table"))


@contextlib.contextmanager
def _fault_entry(lock, registry, entry):
    """Arm ``entry`` in ``registry`` for the context's life, journaled as
    ``chaos_inject`` / ``chaos_clear``."""
    with lock:
        registry.append(entry)
    _journal_chaos("chaos_inject", entry)
    try:
        yield entry
    finally:
        with lock:
            registry.remove(entry)
        _journal_chaos("chaos_clear", entry)


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


def serving_step_failures(times: int = 1, exc_type=RuntimeError,
                          server: Optional[str] = None):
    """Fail the next ``times`` serving batch steps with ``exc_type`` (a
    retryable type counts toward the breaker's threshold, a fatal one
    trips it at once).  ``server`` scopes the fault to one name."""
    return _fault_entry(_SERVING_LOCK, _SERVING_FAULTS, {
        "kind": "fail", "remaining": int(times), "exc_type": exc_type,
        "fired": 0, "server": None if server is None else str(server)})


def serving_step_latency(seconds: float, times: int = 1 << 30,
                         server: Optional[str] = None):
    """Add ``seconds`` of host latency to the next ``times`` serving
    batch steps."""
    return _fault_entry(_SERVING_LOCK, _SERVING_FAULTS, {
        "kind": "latency", "remaining": int(times),
        "seconds": float(seconds), "fired": 0,
        "server": None if server is None else str(server)})


def poison_params(tree):
    """A NaN copy of a param tree (every float leaf) — the hot-swap
    canary must refuse it."""
    def poison(leaf):
        t = torch.as_tensor(leaf)
        return torch.full_like(t, float("nan")) if t.is_floating_point() \
            else t.clone()

    return tree_map(poison, tree)


# ---------------------------------------------------------------------------
# fleet (replica-membership) faults
# ---------------------------------------------------------------------------
# The serving-fleet layer (serving/fleet.py) gives inference the same
# cluster fault surface training got: each ReplicaAgent consults
# check_fleet_fault(replica) once per heartbeat pump, so replica death
# and KV partitions are scheduled deterministically against the
# heartbeat timeline.  ``delay_replica`` rides the per-server scoping
# of the serving injectors above (the slow path is the device step,
# not the heartbeat).

_FLEET_LOCK = threading.Lock()
_FLEET_FAULTS: list = []  # [dict(kind, replica, remaining, fired)]


def check_fleet_fault(replica: str) -> Optional[str]:
    """Called once per heartbeat pump by each ReplicaAgent.  Returns
    the armed fault kind for this replica (``"kill"`` consumes one
    budget unit; ``"partition"`` reports while armed without consuming
    — a partition lasts as long as its context), or None."""
    if not _FLEET_FAULTS:
        return None
    with _FLEET_LOCK:
        for f in _FLEET_FAULTS:
            if f["replica"] != replica or f["remaining"] <= 0:
                continue
            if f["kind"] == "kill":
                f["remaining"] -= 1
            f["fired"] += 1
            return f["kind"]
    return None


def kill_replica(replica: str):
    """Kill serving replica ``replica`` at its next heartbeat pump: its
    server hard-stops (in-flight requests resolve typed, queued ones
    CANCELLED) and its heartbeats cease — the router's missed-heartbeat
    ejection and failover-retry paths are exercised end to end."""
    return _fault_entry(_FLEET_LOCK, _FLEET_FAULTS, {
        "kind": "kill", "replica": str(replica), "remaining": 1,
        "fired": 0})


def delay_replica(replica: str, seconds: float, times: int = 1 << 30):
    """Slow ``replica``'s serving steps by ``seconds`` each — its
    queue grows and its published p99 inflates, driving the router's
    least-loaded routing away from it (the serving analogue of
    :func:`delay_host`)."""
    return serving_step_latency(seconds, times=times, server=replica)


def partition_kv(replica: str):
    """Partition ``replica`` from the fleet KV transport while the
    context is active: its heartbeats and health snapshots stop
    landing, so the router presumes it dead and ejects it; on heal
    (context exit) its beats resume and it is re-admitted — the
    asymmetric-partition case where the replica itself is healthy but
    invisible."""
    return _fault_entry(_FLEET_LOCK, _FLEET_FAULTS, {
        "kind": "partition", "replica": str(replica),
        "remaining": 1 << 30, "fired": 0})


# ---------------------------------------------------------------------------
# continuous-learning loop faults
# ---------------------------------------------------------------------------
# The ContinuousLoop (loop/continuous.py) consults check_loop_fault()
# at two deterministic points: once per deploy attempt with
# kind="poison_candidate" (the captured candidate tree is NaN-poisoned
# before it reaches the fleet — the poisoned-artifact case every
# replica canary must refuse), and once per ingest interval with
# kind="diverge" (that interval's fresh samples are feature-scaled, so
# the next training slice's loss spikes and the TrainingHealthMonitor's
# divergence rule must gate the following deploy).

_LOOP_LOCK = threading.Lock()
_LOOP_FAULTS: list = []  # [dict(kind, remaining, fired, scale?)]


def check_loop_fault(kind: str) -> Optional[dict]:
    """Called by the ContinuousLoop at the injection point named by
    ``kind``; consumes one budget unit and returns a copy of the armed
    entry (carrying e.g. ``scale``), or None.  No-op (and free) when
    nothing is registered."""
    if not _LOOP_FAULTS:
        return None
    with _LOOP_LOCK:
        for f in _LOOP_FAULTS:
            if f["kind"] != kind or f["remaining"] <= 0:
                continue
            f["remaining"] -= 1
            f["fired"] += 1
            return dict(f)
    return None


def poison_candidate(times: int = 1):
    """NaN-poison the next ``times`` deploy candidates the
    ContinuousLoop captures (via :func:`poison_params`) — the
    poisoned-artifact deploy: every replica's canary must reject it
    and the fleet must roll back, never serving a bad param."""
    return _fault_entry(_LOOP_LOCK, _LOOP_FAULTS, {
        "kind": "poison_candidate", "remaining": int(times), "fired": 0})


def loop_loss_divergence(times: int = 1, scale: float = 3.0):
    """Feature-scale the next ``times`` ingest intervals' fresh
    samples by ``scale`` — the loop's training loss spikes well above
    its window minimum, the divergence SLO rule fires, and the deploy
    gate must refuse to roll the damaged candidate until the loss
    recovers (the scaled samples wash out of the bounded streaming
    window)."""
    return _fault_entry(_LOOP_LOCK, _LOOP_FAULTS, {
        "kind": "diverge", "remaining": int(times), "fired": 0,
        "scale": float(scale)})


# ---------------------------------------------------------------------------
# multi-tenant (registry + admission) faults
# ---------------------------------------------------------------------------
# Two deterministic injectors for the multi-tenant serving layer
# (serving/registry.py).  ``tenant_flood`` is an open-loop overload on
# one tenant: the AdmissionController consults check_tenant_flood() at
# every admission decision and counts the armed phantom inflight units
# against that tenant's quota — the flooding tenant hits its weighted
# budget and sheds typed OVERLOADED while every other tenant's budget
# is untouched, with no wall-clock race.  ``unregister_model_mid_
# flight`` vanishes a registry entry at the model's next lookup (one
# consume), so requests already queued for it must resolve typed
# NOT_FOUND with their admission slots and KV pages released.

_TENANT_LOCK = threading.Lock()
_TENANT_FAULTS: list = []  # [dict(kind, tenant|model, remaining, fired, rps?)]


def check_tenant_flood(tenant: str) -> int:
    """Called by the AdmissionController at each admission decision:
    returns the phantom inflight units armed against ``tenant`` (the
    simulated open-loop flood, counted against its quota), consuming
    one budget unit per call.  0 (and free) when nothing is armed."""
    if not _TENANT_FAULTS:
        return 0
    with _TENANT_LOCK:
        for f in _TENANT_FAULTS:
            if (f["kind"] == "flood" and f["tenant"] == tenant
                    and f["remaining"] > 0):
                f["remaining"] -= 1
                f["fired"] += 1
                return int(f["rps"])
    return 0


def check_registry_fault(model: str) -> bool:
    """Called by the ModelRegistry at each lookup: True when an armed
    ``unregister_model_mid_flight`` fault fires for ``model`` (the
    registry then drops the entry — requests queued for it resolve
    typed NOT_FOUND).  No-op (and free) when nothing is armed."""
    if not _TENANT_FAULTS:
        return False
    with _TENANT_LOCK:
        for f in _TENANT_FAULTS:
            if (f["kind"] == "unregister" and f["model"] == model
                    and f["remaining"] > 0):
                f["remaining"] -= 1
                f["fired"] += 1
                return True
    return False


def tenant_flood(tenant: str, rps: int, times: int = 1 << 30):
    """Open-loop overload on ``tenant``: the next ``times`` admission
    decisions see ``rps`` phantom inflight requests charged against its
    quota, so the flooding tenant saturates its weighted budget and
    sheds typed OVERLOADED while under-quota tenants keep their full
    budget — the noisy-neighbor case admission control must contain."""
    return _fault_entry(_TENANT_LOCK, _TENANT_FAULTS, {
        "kind": "flood", "tenant": str(tenant), "rps": int(rps),
        "remaining": int(times), "fired": 0})


def unregister_model_mid_flight(model: str):
    """Vanish ``model``'s registry entry at its next lookup, with
    requests still queued for it: every queued request must resolve
    typed NOT_FOUND (never INTERNAL_ERROR), its admission slot released
    and its KV pages returned to the pool."""
    return _fault_entry(_TENANT_LOCK, _TENANT_FAULTS, {
        "kind": "unregister", "model": str(model), "remaining": 1,
        "fired": 0})
