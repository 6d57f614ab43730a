"""Multi-tenant model registry + per-tenant admission control
(counterpart of ``bigdl_tpu/serving/registry.py``).

Two small, lock-disciplined objects turn the single-model fleet into a
multi-tenant one without touching the per-replica serving machinery:

:class:`ModelRegistry` is the fleet's name service.  Replicas already
advertise health snapshots over the fleet KV; with multi-tenancy each
snapshot also carries the (model, version) pair its server holds, and
the registry records which models are *supposed* to exist.  The router
consults ``lookup(model)`` at admission (a miss is a typed
``NOT_FOUND`` — no queue slot, no retry burn) and re-checks it every
attempt, so an entry that vanishes mid-flight
(:func:`resilience.faults.unregister_model_mid_flight`) converts the
already-queued requests into typed NOT_FOUND instead of letting them
spin against replicas that no longer serve the model.

:class:`AdmissionController` is the noisy-neighbor wall.  Each tenant
gets a weighted share of the router's inflight capacity; admission is
a single atomic check under one lock:

1. tenant over its own budget  → shed ``"tenant_quota"`` — ONLY the
   over-quota tenant sheds (typed OVERLOADED); every under-quota
   tenant keeps its full budget untouched.
2. fleet-wide capacity exhausted → shed ``"global"`` — the only case
   where an under-budget tenant can be refused.
3. otherwise → admitted, one slot charged to the tenant.

Weighted fair shedding *before* global shedding is the ordering the
multi-tenant chaos tests pin: a tenant-A flood
(:func:`resilience.faults.tenant_flood` charges phantom inflight units
against A's quota at every decision) drives A into case 1 while B
rides entirely in case 3.  Budgets are derived once from the quota
weights (``floor(capacity * w_t / Σw)``, min 1), so Σ budgets ≤
capacity and a tenant inside its budget can only be refused by genuine
fleet-wide exhaustion.

Per-tenant deadline budgets ride the same object: ``deadline_for``
clamps a request's deadline to the tenant's ceiling, so one tenant
cannot monopolize replicas with arbitrarily long deadlines.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from ..resilience import faults as _faults
from ..telemetry.events import record_change as _record_change

__all__ = ["ModelRegistry", "AdmissionController"]


class ModelRegistry:
    """Thread-safe (model -> version) table the router admits against.

    The registry is intentionally *descriptive*, not authoritative:
    which replicas actually hold a model comes from their live health
    snapshots (:meth:`advertisers`); the registry only answers "is this
    model supposed to exist, and at which version?" — the admission
    check that makes an unknown model a typed NOT_FOUND instead of a
    retry storm against replicas that will never serve it.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._models: Dict[str, str] = {}

    def register(self, model: str, version: str = "v1") -> str:
        """Register (or re-version) ``model``; returns the version."""
        with self._lock:
            prior = self._models.get(str(model))
            self._models[str(model)] = str(version)
        if prior != str(version):
            _record_change("model_registered", f"version={version}",
                           source="serving.registry", model=model)
        return str(version)

    def unregister(self, model: str) -> bool:
        """Drop ``model``; True when it was registered."""
        with self._lock:
            dropped = self._models.pop(str(model), None) is not None
        if dropped:
            _record_change("model_unregistered",
                           source="serving.registry", model=model)
        return dropped

    def lookup(self, model: str) -> Optional[str]:
        """The registered version of ``model``, or None.

        Consults the armed registry faults first: an
        ``unregister_model_mid_flight`` entry fires here, dropping the
        model so this very lookup (and every later one) misses — the
        deterministic injection point for the vanishing-entry chaos
        case."""
        model = str(model)
        if _faults.check_registry_fault(model):
            self.unregister(model)
        with self._lock:
            return self._models.get(model)

    def has(self, model: str) -> bool:
        return self.lookup(model) is not None

    def models(self) -> Dict[str, str]:
        """Snapshot copy of the (model -> version) table."""
        with self._lock:
            return dict(self._models)

    @staticmethod
    def advertisers(model: str, health: Dict[str, dict]) -> List[str]:
        """Replica ids whose health snapshot advertises ``model``.

        A replica with no ``model`` key (single-model fleets predating
        the registry) advertises nothing here — multi-model routing
        only dispatches over explicit advertisers."""
        model = str(model)
        return [rid for rid, h in health.items()
                if (h or {}).get("model") == model]


class AdmissionController:
    """Per-tenant weighted max-inflight admission with fair shedding.

    ``quotas`` maps tenant -> weight; each tenant's guaranteed budget
    is ``max(1, floor(capacity * weight / Σweights))`` slots.  Tenants
    absent from ``quotas`` get ``default_slots`` (they exist — a new
    tenant must not be an unbounded hole — but carry no reserved
    share).  ``try_admit``/``release`` are atomic under one lock, so
    concurrent admits across tenants can never overshoot either a
    tenant budget or the global capacity, and releases can never drive
    a count negative (the quota-accounting invariants the concurrency
    hammer test pins).
    """

    #: admission-decision vocabulary (the ``decision`` label of
    #: ``bigdl_tenant_admission_total``)
    ADMITTED = "admitted"
    TENANT_QUOTA = "tenant_quota"
    GLOBAL = "global"

    def __init__(self, capacity: int,
                 quotas: Optional[Dict[str, float]] = None,
                 default_slots: int = 1,
                 deadline_budgets: Optional[Dict[str, float]] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._inflight: Dict[str, int] = {}
        self._total = 0
        self._default_slots = max(1, int(default_slots))
        self._deadline_budgets = dict(deadline_budgets or {})
        quotas = dict(quotas or {})
        total_w = sum(max(0.0, float(w)) for w in quotas.values())
        self._budgets: Dict[str, int] = {}
        for tenant, w in quotas.items():
            if total_w <= 0:
                share = self._default_slots
            else:
                share = int(self.capacity * max(0.0, float(w)) / total_w)
            self._budgets[str(tenant)] = max(1, share)

    def budget(self, tenant: str) -> int:
        """The tenant's guaranteed inflight budget (slots)."""
        return self._budgets.get(str(tenant), self._default_slots)

    def try_admit(self, tenant: str) -> Tuple[bool, str]:
        """One atomic admission decision for ``tenant``.

        Returns ``(True, "admitted")`` with one slot charged, or
        ``(False, reason)`` where ``reason`` is ``"tenant_quota"``
        (tenant over its own budget — weighted fair shed) or
        ``"global"`` (fleet-wide capacity exhausted).  An armed
        :func:`resilience.faults.tenant_flood` adds phantom inflight
        units to the tenant's count before the check."""
        tenant = str(tenant)
        phantom = _faults.check_tenant_flood(tenant)
        with self._lock:
            held = self._inflight.get(tenant, 0)
            if held + phantom >= self.budget(tenant):
                return False, self.TENANT_QUOTA
            if self._total >= self.capacity:
                return False, self.GLOBAL
            self._inflight[tenant] = held + 1
            self._total += 1
            return True, self.ADMITTED

    def release(self, tenant: str):
        """Return ``tenant``'s slot.  Over-release is clamped (never a
        negative count) — the router releases exactly once per admitted
        request via the future's single-fire done callback, but a
        clamped floor keeps a buggy caller from corrupting every later
        admission decision."""
        tenant = str(tenant)
        with self._lock:
            held = self._inflight.get(tenant, 0)
            if held > 0:
                self._inflight[tenant] = held - 1
                self._total -= 1

    def inflight(self, tenant: Optional[str] = None) -> int:
        with self._lock:
            if tenant is None:
                return self._total
            return self._inflight.get(str(tenant), 0)

    def deadline_for(self, tenant: str,
                     deadline_s: Optional[float]) -> Optional[float]:
        """Clamp a requested deadline to the tenant's budget (None
        passes an unbudgeted tenant's request through unchanged; a
        budgeted tenant with no requested deadline gets its ceiling)."""
        cap = self._deadline_budgets.get(str(tenant))
        if cap is None:
            return deadline_s
        if deadline_s is None:
            return float(cap)
        return min(float(deadline_s), float(cap))

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "total_inflight": self._total,
                "inflight": dict(self._inflight),
                "budgets": dict(self._budgets),
            }
