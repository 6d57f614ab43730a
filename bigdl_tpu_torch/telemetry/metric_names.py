"""The one shared table of ``bigdl_*`` metric family names.

Every metric family any subsystem registers is declared HERE, as a
constant, and a vocabulary lint (tests/test_torch_telemetry.py) fails on any
``"bigdl_*"`` family-name string literal in ``bigdl_tpu_torch/`` that is not
a member of :data:`METRIC_FAMILY_NAMES` — the span-category lint
pattern (telemetry/trace_context.py), applied to metric names.

Why it exists: the SLO engine (:mod:`.slo`) addresses metric families
*by name* in declarative alert rules.  Before this table, renaming a
family was a silent break — the rule kept evaluating a series that no
longer existed and the alert simply never fired again.  With the
table, rules reference families through these constants, the lint
pins every registration site to the same spelling, and a renamed
metric can never silently orphan an SLO rule.

The table carries NAMES only (the registry still owns kind/labels/
help); modules may keep using string literals at registration sites —
the lint only requires each literal to be a member.
"""
from __future__ import annotations

__all__ = ["METRIC_FAMILY_NAMES"]

# --- training spine (telemetry/__init__.py) ------------------------------
TRAIN_STEPS_TOTAL = "bigdl_train_steps_total"
TRAIN_RECORDS_TOTAL = "bigdl_train_records_total"
TRAIN_STEP_SECONDS = "bigdl_train_step_seconds"
TRAIN_COMPILE_SECONDS = "bigdl_train_compile_seconds"
TRAIN_DATA_WAIT_SECONDS = "bigdl_train_data_wait_seconds"
TRAIN_H2D_SECONDS = "bigdl_train_host_to_device_seconds"
CHECKPOINT_WRITE_SECONDS = "bigdl_checkpoint_write_seconds"
CHECKPOINT_BLOCKED_SECONDS = "bigdl_checkpoint_blocked_seconds"
RECOVERY_WINDOWS_TOTAL = "bigdl_recovery_windows_total"
GUARD_SKIPPED_STEPS_TOTAL = "bigdl_guard_skipped_steps_total"

# --- resilience / elastic / infeed ---------------------------------------
RETRY_ATTEMPTS_TOTAL = "bigdl_retry_attempts_total"
WATCHDOG_TRIPS_TOTAL = "bigdl_watchdog_trips_total"
BREAKER_TRANSITIONS_TOTAL = "bigdl_breaker_transitions_total"
ELASTIC_EVICTIONS_TOTAL = "bigdl_elastic_evictions_total"
ELASTIC_INCARNATION_CHANGES_TOTAL = \
    "bigdl_elastic_incarnation_changes_total"
MESH_REBUILDS_TOTAL = "bigdl_mesh_rebuilds_total"
INTEGRITY_VOTES_TOTAL = "bigdl_integrity_votes_total"
INTEGRITY_DISAGREEMENTS_TOTAL = "bigdl_integrity_disagreements_total"
CHECKPOINT_ASYNC_WRITES_TOTAL = "bigdl_checkpoint_async_writes_total"
CHECKPOINT_ASYNC_WRITE_SECONDS_TOTAL = \
    "bigdl_checkpoint_async_write_seconds_total"
INFEED_BUFFER_HITS_TOTAL = "bigdl_infeed_buffer_hits_total"
INFEED_BUFFER_MISSES_TOTAL = "bigdl_infeed_buffer_misses_total"

# --- performance accounting (telemetry/perf.py, parallel/plan.py) --------
PERF_FLOPS_PER_STEP = "bigdl_perf_flops_per_step"
PERF_BYTES_PER_STEP = "bigdl_perf_bytes_per_step"
PERF_COLLECTIVE_BYTES = "bigdl_perf_collective_bytes"
PERF_SPARSE_BYTES_SAVED = "bigdl_perf_sparse_bytes_saved"
PERF_SYNC_BYTES_SAVED = "bigdl_perf_sync_bytes_saved"
PERF_SPARSE_FLOPS_SKIPPED = "bigdl_perf_sparse_flops_skipped"
PERF_ARITHMETIC_INTENSITY = "bigdl_perf_arithmetic_intensity"
PERF_MFU = "bigdl_perf_mfu"
PERF_MODEL_FLOPS_PER_SEC = "bigdl_perf_model_flops_per_sec"
PERF_FLOPS_TOTAL = "bigdl_perf_flops_total"
PERF_HBM_BYTES_IN_USE = "bigdl_perf_hbm_bytes_in_use"
PERF_HBM_PEAK_BYTES = "bigdl_perf_hbm_peak_bytes"
PERF_HBM_LIMIT_BYTES = "bigdl_perf_hbm_limit_bytes"
PLAN_PARAM_BYTES_PER_DEVICE = "bigdl_plan_param_bytes_per_device"
PLAN_PARAM_BYTES_TOTAL = "bigdl_plan_param_bytes_total"

# --- serving (serving/metrics.py, router.py, autoscale.py) ---------------
SERVING_REQUESTS_TOTAL = "bigdl_serving_requests_total"
SERVING_LATENCY_SECONDS = "bigdl_serving_latency_seconds"
SERVING_QUEUED_SECONDS = "bigdl_serving_queued_seconds"
SERVING_QUEUE_DEPTH = "bigdl_serving_queue_depth"
SERVING_BATCHES_TOTAL = "bigdl_serving_batches_total"
SERVING_PADDED_ROWS_TOTAL = "bigdl_serving_padded_rows_total"
SERVING_FLOPS_TOTAL = "bigdl_serving_flops_total"
SERVING_SWAPS_TOTAL = "bigdl_serving_swaps_total"
SERVING_HEDGES_TOTAL = "bigdl_serving_hedges_total"
SERVING_RETRIES_TOTAL = "bigdl_serving_retries_total"
SERVING_PHASE_SECONDS = "bigdl_serving_phase_seconds"
SERVING_TTFT_SECONDS = "bigdl_serving_ttft_seconds"
SERVING_TPOT_SECONDS = "bigdl_serving_tpot_seconds"
SERVING_KV_PAGES_TOTAL = "bigdl_serving_kv_pages_total"
SERVING_KV_PAGES_FREE = "bigdl_serving_kv_pages_free"
SERVING_KV_OCCUPANCY = "bigdl_serving_kv_occupancy"
FLEET_DISPATCH_TOTAL = "bigdl_fleet_dispatch_total"
AUTOSCALE_DECISIONS_TOTAL = "bigdl_autoscale_decisions_total"

# --- multi-tenant fleet (serving/registry.py, router.py, metrics.py) ------
#: per-tenant twins of the serving families.  The metrics registry pins
#: each family to ONE label tuple, so tenant observability lives in
#: parallel ``bigdl_tenant_*`` families rather than widening the
#: existing ones (which would break every registered series).
TENANT_REQUESTS_TOTAL = "bigdl_tenant_requests_total"
TENANT_SHEDS_TOTAL = "bigdl_tenant_sheds_total"
TENANT_PHASE_SECONDS = "bigdl_tenant_phase_seconds"
TENANT_TTFT_SECONDS = "bigdl_tenant_ttft_seconds"
TENANT_TPOT_SECONDS = "bigdl_tenant_tpot_seconds"
TENANT_DISPATCH_TOTAL = "bigdl_tenant_dispatch_total"
#: router admission decisions, labeled {tenant, decision}:
#: admitted | tenant_quota | global | not_found | flood
TENANT_ADMISSION_TOTAL = "bigdl_tenant_admission_total"
TENANT_INFLIGHT = "bigdl_tenant_inflight"
#: KV pages currently held per pool owner (labels: tenant)
TENANT_KV_PAGES_HELD = "bigdl_tenant_kv_pages_held"

# --- the online health engine (timeseries.py + slo.py) -------------------
#: structured alert transitions, labeled {rule, severity, state}
ALERTS_TOTAL = "bigdl_alerts_total"
#: number of alerts currently firing in one engine
ALERTS_ACTIVE = "bigdl_alerts_active"
#: per-role-pool control signals the autoscaler feeds its recorder
#: (labels: pool) — what the default serving rule pack evaluates
AUTOSCALE_POOL_P99_SECONDS = "bigdl_autoscale_pool_p99_seconds"
AUTOSCALE_POOL_QUEUE_DEPTH = "bigdl_autoscale_pool_queue_depth"
AUTOSCALE_POOL_KV_OCCUPANCY = "bigdl_autoscale_pool_kv_occupancy"
AUTOSCALE_POOL_SHED_RATE = "bigdl_autoscale_pool_shed_rate"
AUTOSCALE_POOL_SHED_TOTAL = "bigdl_autoscale_pool_shed_total"
AUTOSCALE_POOL_REQUESTS_TOTAL = "bigdl_autoscale_pool_requests_total"
#: per-replica health signals the fleet health monitor feeds (labels:
#: replica) — what the per-replica degradation rules evaluate
REPLICA_P99_SECONDS = "bigdl_replica_p99_seconds"
REPLICA_QUEUE_DEPTH = "bigdl_replica_queue_depth"
REPLICA_ERRORS_TOTAL = "bigdl_replica_errors_total"
REPLICA_REQUESTS_TOTAL = "bigdl_replica_requests_total"
#: training health signals the TrainingHealthMonitor feeds
TRAIN_LOSS = "bigdl_train_loss"
TRAIN_STEP_TIME_SECONDS = "bigdl_train_step_time_seconds"
GOODPUT_PRODUCTIVE_FRACTION = "bigdl_goodput_productive_fraction"

# --- continuous-learning loop (loop/continuous.py) ------------------------
#: deploy state-machine terminal outcomes, labeled {outcome}:
#: confirmed | gated | rejected | rolled_back | refused
LOOP_DEPLOYS_TOTAL = "bigdl_loop_deploys_total"
#: cumulative fresh ingest batches the loop has absorbed — the series
#: the ingest dead-man rule watches (a stalled stream goes silent here)
LOOP_INGEST_BATCHES_TOTAL = "bigdl_loop_ingest_batches_total"
#: fleet-wide served request totals the loop feeds its recorder each
#: interval — the denominator/numerator of the post-swap burn-rate
#: watch (bad = internal_error + unavailable + deadline_exceeded)
LOOP_SERVED_REQUESTS_TOTAL = "bigdl_loop_served_requests_total"
LOOP_SERVED_BAD_TOTAL = "bigdl_loop_served_bad_total"

# --- parameter-server embedding store (nn/embedding_store.py +
# --- serving/sparse_fetch.py) ---------------------------------------------
#: the live table version per table (labels: table) — bumped by every
#: repartition; the serving fetch publishes it in health snapshots and
#: the hot-row cache retires every entry from prior versions
EMBED_TABLE_VERSION = "bigdl_embed_table_version"
#: hot-row cache traffic on the remote-sparse-fetch path (labels: table)
EMBED_CACHE_HITS_TOTAL = "bigdl_embed_cache_hits_total"
EMBED_CACHE_MISSES_TOTAL = "bigdl_embed_cache_misses_total"
#: rows moved by live re-partitioning (labels: table) — ~1/N of the
#: table per 1-host delta under consistent assignment
EMBED_ROWS_MIGRATED_TOTAL = "bigdl_embed_rows_migrated_total"
#: lookups shed typed (deadline/migration/breaker) instead of served
#: unverified (labels: table)
EMBED_ROWS_SHED_TOTAL = "bigdl_embed_rows_shed_total"
#: rows served that failed verification — the must-stay-zero audit
#: every embedding chaos test pins (labels: table)
EMBED_BAD_ROWS_TOTAL = "bigdl_embed_bad_rows_total"

# --- incident engine (telemetry/events.py + incidents.py) -----------------
#: state-change events recorded into the fleet-wide change journal,
#: labeled {kind} (deploy_started, membership_evict, chaos_inject, ...)
CHANGE_EVENTS_TOTAL = "bigdl_change_events_total"
#: incidents opened by the IncidentEngine, labeled {severity}
INCIDENTS_TOTAL = "bigdl_incidents_total"
#: incidents currently holding an open capture window
INCIDENTS_ACTIVE = "bigdl_incidents_active"

#: every bigdl_* metric family name any bigdl_tpu_torch module may register
#: or reference — the vocabulary the lint enforces
METRIC_FAMILY_NAMES = frozenset(
    v for k, v in list(globals().items())
    if isinstance(v, str) and v.startswith("bigdl_")
    and k.isupper())
