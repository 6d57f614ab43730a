"""Per-request serving metrics: counters + latency quantiles, backed
by the unified telemetry registry.

Counts every terminal status (a shed request increments ``shed`` and
nothing else — never a silent drop), tracks queue depth at admission,
and answers p50/p99 from a :class:`~bigdl_tpu.telemetry.Histogram`
whose bounded exact-sample window reproduces numpy-percentile
semantics over the most recent ``window`` requests — the same numbers
the pre-registry deque implementation reported.  The histograms'
log-bucket state additionally merges across hosts in the cross-host
telemetry view (docs/observability.md).

``to_summary`` exports the snapshot through the tensorboard-compatible
``visualization.summary`` writer so serving health lands next to the
training curves; the backing registry (one private registry per
server by default, so two servers in one process never blend their
counts) exports Prometheus text via ``metrics.registry
.to_prometheus()``.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from ..telemetry.registry import MetricsRegistry, default_buckets
from .status import Status

#: latency window — big enough for stable p99, bounded so a long-lived
#: server never grows without limit
_WINDOW = 8192

#: latency bucket ladder: 100µs … ~100s (log-spaced, mergeable)
_LATENCY_BUCKETS = default_buckets(start=1e-4, factor=2.0, count=21)
#: queue-depth ladder: 1 … 2^15
_DEPTH_BUCKETS = default_buckets(start=1.0, factor=2.0, count=16)


class ServingMetrics:
    def __init__(self, window: int = _WINDOW,
                 registry: Optional[MetricsRegistry] = None):
        self._lock = threading.Lock()
        #: the device whose peak ``goodput_per_chip`` divides by (the
        #: server sets its model's; None: the card, else the CPU row)
        self.device = None
        self.registry = registry or MetricsRegistry()
        self._requests = self.registry.counter(
            "bigdl_serving_requests_total",
            "terminal request statuses", labels=("status",))
        self._lat = self.registry.histogram(
            "bigdl_serving_latency_seconds",
            "end-to-end latency of OK requests",
            bounds=_LATENCY_BUCKETS, window=window)
        self._queued = self.registry.histogram(
            "bigdl_serving_queued_seconds",
            "queue-wait portion of OK requests",
            bounds=_LATENCY_BUCKETS, window=window)
        self._depth = self.registry.histogram(
            "bigdl_serving_queue_depth",
            "admission-time queue depth",
            bounds=_DEPTH_BUCKETS, window=window)
        self._batches = self.registry.counter(
            "bigdl_serving_batches_total", "compiled batches executed")
        self._padded = self.registry.counter(
            "bigdl_serving_padded_rows_total",
            "bucket-padding rows executed")
        self._flops = self.registry.counter(
            "bigdl_serving_flops_total",
            "XLA cost-model FLOPs dispatched (per-bucket static "
            "cost x batches)", labels=("bucket",))
        # hot-swap outcomes and tail-latency hedging land in the same
        # registry so the fleet fold (telemetry.aggregate.merge_metrics)
        # and to_prometheus() carry them — a rejected deploy or a hedge
        # storm must be visible in the scraped view, not just in
        # python attributes
        self._swaps = self.registry.counter(
            "bigdl_serving_swaps_total",
            "hot param swap outcomes", labels=("outcome",))
        self._hedges = self.registry.counter(
            "bigdl_serving_hedges_total",
            "tail-latency hedges (fired = duplicate sent, won = the "
            "hedge's response was used, suppressed = a decode-phase "
            "hedge the router refused — duplicating a long decode "
            "doubles HBM + KV-pool pressure)", labels=("event",))
        self._retries = self.registry.counter(
            "bigdl_serving_retries_total",
            "failover retries dispatched to another replica")
        # the generation-phase family (paged/disaggregated serving):
        # prefill = prompt pass + first token, decode = the rest.
        # TTFT/TPOT are the two numbers a serving SLO is written in —
        # p50/p99 land in snapshot() next to the request latencies
        self._phase = self.registry.histogram(
            "bigdl_serving_phase_seconds",
            "wall seconds per generation phase",
            labels=("phase",), bounds=_LATENCY_BUCKETS, window=window)
        self._ttft = self.registry.histogram(
            "bigdl_serving_ttft_seconds",
            "submit -> first generated token (time-to-first-token)",
            bounds=_LATENCY_BUCKETS, window=window)
        self._tpot = self.registry.histogram(
            "bigdl_serving_tpot_seconds",
            "decode seconds per generated token "
            "(time-per-output-token)",
            bounds=_LATENCY_BUCKETS, window=window)
        # per-tenant twins of the request/shed/phase families.  The
        # registry pins each family to ONE label tuple, so tenant
        # observability lives in parallel bigdl_tenant_* families
        # (metric_names.py) instead of widening the existing ones;
        # series only appear for requests that actually carry a tenant,
        # so single-model fleets pay nothing
        self._tenant_requests = self.registry.counter(
            "bigdl_tenant_requests_total",
            "terminal request statuses per tenant",
            labels=("tenant", "status"))
        self._tenant_sheds = self.registry.counter(
            "bigdl_tenant_sheds_total",
            "admission rejections per tenant (reason: tenant_quota = "
            "weighted fair shed of the over-quota tenant, global = "
            "fleet-wide exhaustion, not_found = unregistered model)",
            labels=("tenant", "reason"))
        self._tenant_phase = self.registry.histogram(
            "bigdl_tenant_phase_seconds",
            "wall seconds per generation phase per tenant",
            labels=("tenant", "phase"), bounds=_LATENCY_BUCKETS,
            window=window)
        self._tenant_ttft = self.registry.histogram(
            "bigdl_tenant_ttft_seconds",
            "time-to-first-token per tenant",
            labels=("tenant",), bounds=_LATENCY_BUCKETS, window=window)
        self._tenant_tpot = self.registry.histogram(
            "bigdl_tenant_tpot_seconds",
            "time-per-output-token per tenant",
            labels=("tenant",), bounds=_LATENCY_BUCKETS, window=window)
        self._tenant_kv_held = self.registry.gauge(
            "bigdl_tenant_kv_pages_held",
            "KV pages currently held per pool owner",
            labels=("tenant",))
        # KV page-pool occupancy gauges (zero-valued when the server
        # has no pool — the fleet fold may sum them safely)
        self._kv_total = self.registry.gauge(
            "bigdl_serving_kv_pages_total", "KV page-pool capacity")
        self._kv_free = self.registry.gauge(
            "bigdl_serving_kv_pages_free", "KV page-pool free pages")
        self._kv_occupancy = self.registry.gauge(
            "bigdl_serving_kv_occupancy",
            "KV page-pool occupancy fraction (in-use / capacity)")
        # per-bucket static cost (XLA cost model) + the wall window the
        # flops were spent in — what goodput-per-chip divides by
        self._bucket_flops: Dict[int, float] = {}
        self._t_first_batch: Optional[float] = None
        self._t_last_batch: Optional[float] = None
        self.counts: Dict[str, int] = {s.value: 0 for s in Status}
        # amortized p99 for per-request consumers (tail sampler, hedge
        # delay): the exact-window quantile sorts up to `window`
        # samples — at request rate that is an O(n log n) tax per
        # request, so hot-path readers get a value recomputed every
        # `_P99_REFRESH` observations instead
        self._p99_cache: Optional[float] = None
        self._p99_cache_count = -1

    _P99_REFRESH = 64

    def latency_p99(self) -> Optional[float]:
        """The OK-latency p99, recomputed at most every
        ``_P99_REFRESH`` observations — the hot-path spelling of
        ``snapshot()["latency_p99_s"]`` (which stays exact)."""
        count = self._lat.count
        with self._lock:
            if count - self._p99_cache_count < self._P99_REFRESH \
                    and self._p99_cache_count >= 0:
                return self._p99_cache
        p99 = self._lat.quantile(0.99)
        with self._lock:
            self._p99_cache = p99
            self._p99_cache_count = count
        return p99

    # ------------------------------------------------------------------
    def record(self, status: Status, latency_s: float = 0.0,
               queued_s: float = 0.0,
               trace_id: Optional[str] = None,
               tenant: Optional[str] = None):
        """One terminal request outcome.  ``trace_id`` (a KEPT
        distributed trace) attaches as a Prometheus-style exemplar to
        the latency bucket the request landed in — the scraped
        histogram links straight to a stitched timeline.  ``tenant``
        additionally lands the outcome in the per-tenant twin family."""
        with self._lock:
            self.counts[status.value] += 1
        self._requests.labels(status=status.value).inc()
        if tenant is not None:
            self._tenant_requests.labels(
                tenant=str(tenant), status=status.value).inc()
        if status is Status.OK:
            self._lat.observe(latency_s, exemplar=trace_id)
            self._queued.observe(queued_s)

    def record_shed(self, tenant: str, reason: str):
        """One per-tenant admission rejection (``tenant_quota`` |
        ``global`` | ``not_found``) — the series the weighted-shed
        ordering and victim-sheds-zero audits read."""
        self._tenant_sheds.labels(tenant=str(tenant),
                                  reason=str(reason)).inc()

    def record_depth(self, depth: int):
        self._depth.observe(depth)

    #: the hot-swap outcome vocabulary: a normal install, a canary/
    #: verify refusal (prior params keep serving), and a rollback
    #: re-install (a fleet deploy halted or an SLO alert fired and the
    #: captured prior params rode the verified install path back in)
    SWAP_OUTCOMES = ("installed", "rejected", "rolled_back")

    def record_swap(self, installed: bool = True,
                    outcome: Optional[str] = None):
        """One hot-swap outcome.  ``installed=True/False`` is the
        legacy install/reject spelling; ``outcome`` names any member
        of :data:`SWAP_OUTCOMES` directly — a fleet rollback records
        ``rolled_back`` so the scraped counter distinguishes a
        re-verified rollback install from a fresh deploy."""
        if outcome is None:
            outcome = "installed" if installed else "rejected"
        if outcome not in self.SWAP_OUTCOMES:
            raise ValueError(f"unknown swap outcome {outcome!r}; one "
                             f"of {self.SWAP_OUTCOMES}")
        self._swaps.labels(outcome=outcome).inc()

    def record_hedge(self, won: bool = False):
        """One hedging event: ``record_hedge()`` when the duplicate is
        sent (fired), ``record_hedge(won=True)`` when the hedge's
        response beat the primary and was used."""
        self._hedges.labels(event="won" if won else "fired").inc()

    def record_hedge_suppressed(self):
        """A decode-phase hedge the router refused to fire (the
        ``hedge_decode`` knob) — counted so hedge duty stays auditable
        even when the answer is 'no'."""
        self._hedges.labels(event="suppressed").inc()

    def record_retry(self):
        self._retries.inc()

    def record_phase(self, phase: str, seconds: float,
                     tenant: Optional[str] = None):
        """One generation phase's wall time (``prefill`` | ``decode``)."""
        self._phase.labels(phase=phase).observe(seconds)
        if tenant is not None:
            self._tenant_phase.labels(
                tenant=str(tenant), phase=phase).observe(seconds)

    def record_ttft(self, seconds: float, tenant: Optional[str] = None):
        self._ttft.observe(seconds)
        if tenant is not None:
            self._tenant_ttft.labels(tenant=str(tenant)).observe(seconds)

    def record_tpot(self, seconds: float, tenant: Optional[str] = None):
        self._tpot.observe(seconds)
        if tenant is not None:
            self._tenant_tpot.labels(tenant=str(tenant)).observe(seconds)

    def set_kv_pool(self, stats: Optional[dict]):
        """Refresh the KV page-pool gauges from
        ``KVPagePool.stats()`` (no-op on None)."""
        if not stats:
            return
        self._kv_total.set(float(stats.get("num_pages", 0)))
        self._kv_free.set(float(stats.get("free_pages", 0)))
        self._kv_occupancy.set(float(stats.get("occupancy", 0.0)))
        for owner, held in (stats.get("by_owner") or {}).items():
            self._tenant_kv_held.labels(tenant=str(owner)).set(
                float(held))

    def _counter_value(self, name: str, **labels) -> int:
        fam = self.registry.get(name)
        if fam is None:
            return 0
        for got, child in fam.series():
            if all(got.get(k) == v for k, v in labels.items()):
                return int(child.value)
        return 0

    @property
    def swaps(self) -> int:
        return self._counter_value("bigdl_serving_swaps_total",
                                   outcome="installed")

    @property
    def swap_rollbacks(self) -> int:
        return self._counter_value("bigdl_serving_swaps_total",
                                   outcome="rejected")

    @property
    def swaps_rolled_back(self) -> int:
        """Rollback re-installs on this replica (the
        ``outcome="rolled_back"`` leg of the swap counter)."""
        return self._counter_value("bigdl_serving_swaps_total",
                                   outcome="rolled_back")

    @property
    def hedges_fired(self) -> int:
        return self._counter_value("bigdl_serving_hedges_total",
                                   event="fired")

    @property
    def hedges_won(self) -> int:
        return self._counter_value("bigdl_serving_hedges_total",
                                   event="won")

    @property
    def hedges_suppressed(self) -> int:
        return self._counter_value("bigdl_serving_hedges_total",
                                   event="suppressed")

    @property
    def retries(self) -> int:
        return int(self._retries.value)

    def record_bucket_cost(self, bucket: int, flops: float):
        """Install the static cost of one bucket's compiled forward
        (analyzed once per bucket by the server)."""
        with self._lock:
            self._bucket_flops[int(bucket)] = float(flops)

    def record_batch(self, real: int, bucket: int):
        self._batches.inc()
        self._padded.inc(bucket - real)
        now = time.monotonic()
        with self._lock:
            flops = self._bucket_flops.get(int(bucket), 0.0)
            if self._t_first_batch is None:
                self._t_first_batch = now
            self._t_last_batch = now
        if flops:
            self._flops.labels(bucket=str(int(bucket))).inc(flops)

    # ------------------------------------------------------------------
    @property
    def batches(self) -> int:
        return int(self._batches.value)

    @property
    def padded_rows(self) -> int:
        return int(self._padded.value)

    @property
    def flops_total(self) -> float:
        fam = self.registry.get("bigdl_serving_flops_total")
        return float(sum(child.value for _, child in fam.series())) \
            if fam is not None else 0.0

    def batch_window(self):
        """(first, last) batch wall-clock marks — what a fleet fold
        uses to compute one shared serving window; (None, None) before
        any batch."""
        with self._lock:
            return self._t_first_batch, self._t_last_batch

    def goodput_per_chip(self) -> dict:
        """Model-FLOP/s actually served over the first→last batch wall
        window, and that rate as a fraction of the chip's peak — the
        serving analogue of training MFU.  Zeros before any analyzed
        bucket has dispatched (CPU-only servers with no cost analysis
        report flops_total 0, never an error)."""
        with self._lock:
            t0, t1 = self._t_first_batch, self._t_last_batch
        total = self.flops_total
        wall = (t1 - t0) if (t0 is not None and t1 is not None) else 0.0
        rate = total / wall if wall > 0 else 0.0
        out = {"flops_total": total, "wall_s": wall,
               "model_flops_per_sec": rate, "mfu": None}
        if rate > 0:
            try:
                from ..telemetry.device_info import current_device_spec

                spec = current_device_spec(self.device)
                if spec.peak_flops_per_sec:
                    out["mfu"] = rate / spec.peak_flops_per_sec
                    out["nominal_device"] = spec.nominal
            except Exception:
                pass
        return out

    def tenants(self) -> dict:
        """Per-tenant request/shed counts folded from the tenant twin
        families — {} on a fleet that never carried a tenant."""
        out: Dict[str, dict] = {}

        def _tenant(name):
            return out.setdefault(
                name, {"requests": {}, "sheds": {}, "total": 0,
                       "served_ok": 0, "shed_total": 0})

        fam = self.registry.get("bigdl_tenant_requests_total")
        if fam is not None:
            for lbl, child in fam.series():
                d = _tenant(lbl.get("tenant"))
                n = int(child.value)
                d["requests"][lbl.get("status")] = n
                d["total"] += n
                if lbl.get("status") == Status.OK.value:
                    d["served_ok"] += n
        fam = self.registry.get("bigdl_tenant_sheds_total")
        if fam is not None:
            for lbl, child in fam.series():
                d = _tenant(lbl.get("tenant"))
                n = int(child.value)
                d["sheds"][lbl.get("reason")] = n
                d["shed_total"] += n
        return out

    def snapshot(self) -> dict:
        gpc = self.goodput_per_chip()
        with self._lock:
            counts = dict(self.counts)
        ok = counts[Status.OK.value]
        total = sum(counts.values())
        return {
            "served_ok": ok,
            "total": total,
            "shed": counts[Status.OVERLOADED.value],
            "deadline_exceeded":
                counts[Status.DEADLINE_EXCEEDED.value],
            "unavailable": counts[Status.UNAVAILABLE.value],
            "internal_error":
                counts[Status.INTERNAL_ERROR.value],
            "cancelled": counts[Status.CANCELLED.value],
            "not_found": counts[Status.NOT_FOUND.value],
            "shed_rate": (counts[Status.OVERLOADED.value]
                          / total) if total else 0.0,
            "latency_p50_s": self._lat.quantile(0.50),
            "latency_p99_s": self._lat.quantile(0.99),
            "queued_mean_s": self._queued.mean,
            "queue_depth_mean": self._depth.mean,
            "queue_depth_max": (int(self._depth.max)
                                if self._depth.count else 0),
            "batches": self.batches,
            "padded_rows": self.padded_rows,
            "swaps": self.swaps,
            "swap_rollbacks": self.swap_rollbacks,
            "swaps_rolled_back": self.swaps_rolled_back,
            "hedges_fired": self.hedges_fired,
            "hedges_won": self.hedges_won,
            "hedges_suppressed": self.hedges_suppressed,
            "retries": self.retries,
            # per-phase generation view (None until the paged /
            # disaggregated path has served a request)
            "ttft_p50_s": self._ttft.quantile(0.50),
            "ttft_p99_s": self._ttft.quantile(0.99),
            "tpot_p50_s": self._tpot.quantile(0.50),
            "tpot_p99_s": self._tpot.quantile(0.99),
            "prefill_p99_s":
                self._phase.labels(phase="prefill").quantile(0.99),
            "decode_p99_s":
                self._phase.labels(phase="decode").quantile(0.99),
            "kv_pages_total": int(self._kv_total.value),
            "kv_pages_free": int(self._kv_free.value),
            "kv_occupancy": float(self._kv_occupancy.value),
            "flops_total": gpc["flops_total"],
            "model_flops_per_sec": gpc["model_flops_per_sec"],
            "serving_mfu": gpc["mfu"],
            "tenants": self.tenants(),
        }

    def to_summary(self, summary, step: int):
        """Write the snapshot's numeric fields as scalar events (tags
        ``serving/<field>``) through a ``visualization.summary.Summary``
        (e.g. :class:`~bigdl_tpu.visualization.summary.ServingSummary`).
        """
        for key, val in self.snapshot().items():
            if not isinstance(val, (int, float)):
                continue
            summary.add_scalar(f"serving/{key}", float(val), step)
        return summary

    def to_prometheus(self) -> str:
        """Prometheus text exposition of the backing registry."""
        return self.registry.to_prometheus()
