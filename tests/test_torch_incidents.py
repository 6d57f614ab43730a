"""The port's incident engine (``bigdl_tpu_torch/telemetry/events.py`` +
``incidents.py``, the alert and incident cluster folds) against the JAX
package's, on the CPU.

Every spec of ``tests/test_incidents.py`` whose module the port has is
mirrored: the same events, on the same injected clock, go through the
JAX objects and their port counterparts; each scenario makes the
reference's assertions on both, and the two sides' journals, incident
bundles and folds must be equal.  The ``trace_report`` spec holds the
port's ``serving/trace_report.py`` against the JAX repository's
``tools/trace_report.py``.
"""
import pytest
import torch

import bigdl_tpu.telemetry as jtel
import bigdl_tpu_torch.telemetry as ttel
from bigdl_tpu_torch.telemetry import metric_names as M
from bigdl_tpu_torch.telemetry.events import CHANGE_EVENT_KINDS, SCOPE_KEYS

torch.set_num_threads(1)

PACKAGES = {"jax": jtel, "port": ttel}


class Clock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def tick(self, dt=1.0):
        self.t += dt
        return self.t


def _timeless(obj):
    """``obj`` without ``capture_latency_s``, the one reading each engine
    takes from the host's own clock (the time its capture took)."""
    if isinstance(obj, dict):
        return {k: _timeless(v) for k, v in obj.items()
                if k != "capture_latency_s"}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_timeless(v) for v in obj)
    return obj


def _both(scenario):
    """Run ``scenario(package)`` on the JAX telemetry package and on the
    port's; their readings must be equal but for capture latencies.
    Returns the port's."""
    got = {name: _timeless(scenario(pkg)) for name, pkg in PACKAGES.items()}
    assert got["port"] == got["jax"]
    return got["port"]


def test_event_vocabulary_is_the_reference_vocabulary():
    from bigdl_tpu.telemetry import events as jevents

    assert CHANGE_EVENT_KINDS == jevents.CHANGE_EVENT_KINDS
    assert SCOPE_KEYS == jevents.SCOPE_KEYS


# ---------------------------------------------------------------------------
# change journal: vocabulary, scope, bounds, throttling, slicing
# ---------------------------------------------------------------------------

def test_journal_records_ordered_scoped_events():
    def scenario(T):
        c = Clock(100.0)
        reg = T.MetricsRegistry()
        j = T.ChangeJournal(clock=c, registry=reg)
        e0 = j.record("deploy_started", "version=v2", source="fleet",
                      model="alpha", replica="r0")
        c.tick()
        e1 = j.record("autoscale_up", pool="decode", tenant=None,
                      bogus="nope")
        assert (e0.seq, e1.seq) == (0, 1)
        assert e0.at == 100.0 and e1.at == 101.0
        assert e0.scope == {"model": "alpha", "replica": "r0"}
        assert e1.scope == {"pool": "decode"}
        assert not e0.ground_truth and set(e0.scope) <= set(SCOPE_KEYS)
        counts = {s["labels"]["kind"]: s["value"]
                  for s in reg.snapshot()["metrics"]
                  [M.CHANGE_EVENTS_TOTAL]["series"]}
        assert counts == {"deploy_started": 1.0, "autoscale_up": 1.0}
        d = e0.to_dict()
        assert d["kind"] == "deploy_started" and d["seq"] == 0
        return d, e1.to_dict(), counts

    _both(scenario)


def test_journal_rejects_unlisted_kind():
    def scenario(T):
        j = T.ChangeJournal(registry=T.MetricsRegistry())
        with pytest.raises(ValueError, match="unknown change-event kind"):
            j.record("coffee_spilled")
        return len(j)

    _both(scenario)


def test_journal_ring_is_bounded_but_counts_everything():
    def scenario(T):
        j = T.ChangeJournal(capacity=4, clock=Clock(),
                            registry=T.MetricsRegistry())
        for i in range(10):
            j.record("membership_change", f"n={i}", now=float(i))
        snap = j.snapshot()
        assert len(j) == 4 and snap["recorded"] == 10
        assert snap["capacity"] == 4
        assert [e["detail"] for e in snap["events"]] == \
            ["n=6", "n=7", "n=8", "n=9"]
        return snap

    _both(scenario)


def test_journal_since_until_slicing_inclusive():
    def scenario(T):
        j = T.ChangeJournal(registry=T.MetricsRegistry())
        for t in (1.0, 2.0, 3.0, 4.0):
            j.record("breaker_open", now=t, replica=f"r{int(t)}")
        out = [[e.at for e in j.events(since=2.0, until=3.0)],
               [e.at for e in j.events(since=3.0)],
               [e.at for e in j.events(until=1.0)]]
        assert out == [[2.0, 3.0], [3.0, 4.0], [1.0]]
        return out

    _both(scenario)


def test_journal_throttles_high_rate_sites():
    def scenario(T):
        c = Clock(0.0)
        j = T.ChangeJournal(clock=c, registry=T.MetricsRegistry())
        assert j.record_throttled("tenant_shed", key="a",
                                  tenant="a") is not None
        for _ in range(50):
            assert j.record_throttled("tenant_shed", key="a",
                                      tenant="a") is None
        assert j.record_throttled("tenant_shed", key="b",
                                  tenant="b") is not None
        c.tick(2.0)
        assert j.record_throttled("tenant_shed", key="a",
                                  tenant="a") is not None
        assert len(j) == 3 and j.dropped == 50
        assert j.snapshot()["dropped_throttled"] == 50
        return j.snapshot()

    _both(scenario)


def test_default_journal_record_change_and_reset_isolation():
    def scenario(T):
        c = Clock(10.0)
        j = T.reset_default_journal(clock=c)
        try:
            T.record_change("model_registered", "version=1", model="m")
            T.record_change("tenant_shed", tenant="t",
                            throttle_key="t/quota")
            T.record_change("tenant_shed", tenant="t",
                            throttle_key="t/quota")
            kinds = [e.kind for e in j.events()]
            assert kinds == ["model_registered", "tenant_shed"]
            j2 = T.reset_default_journal()
            assert len(j2) == 0 and j2 is not j
            return kinds
        finally:
            T.reset_default_journal()

    _both(scenario)


# ---------------------------------------------------------------------------
# incident lifecycle: open, capture, onset, finalize
# ---------------------------------------------------------------------------

def _wire(T, rules, pre_window_s=60.0, post_intervals=2, **policy_kw):
    c = Clock(1000.0)
    rec = T.MetricRecorder(clock=c)
    j = T.ChangeJournal(clock=c, registry=T.MetricsRegistry())
    eng = T.SloEngine(rec, rules=rules, registry=T.MetricsRegistry(),
                      clock=c)
    reg = T.MetricsRegistry()
    ie = T.IncidentEngine(
        rec, journal=j, engine=eng, registry=reg,
        policy=T.IncidentPolicy(pre_window_s=pre_window_s,
                                post_intervals=post_intervals, **policy_kw),
        clock=c)
    return c, rec, j, eng, ie, reg


def _p99_rule(T):
    return [T.SloRule(name="replica/r1/p99", family=M.REPLICA_P99_SECONDS,
                      labels={"replica": "r1"}, kind="threshold",
                      reduce="last", op=">=", threshold=1.0, window_s=30.0,
                      for_intervals=2, resolve_intervals=2,
                      description="replica r1 p99 >= 1s")]


def test_incident_opens_on_firing_and_finalizes_after_post_window():
    def scenario(T):
        c, rec, j, eng, ie, reg = _wire(T, _p99_rule(T))
        L = {"replica": "r1"}
        for _ in range(10):
            rec.observe(M.REPLICA_P99_SECONDS, 0.05, labels=L)
            assert ie.observe(eng.evaluate()) == []
            c.tick(5.0)
        j.record("deploy_started", "version=v2", replica="r1",
                 model="alpha")
        finalized, rounds_after_open = [], 0
        for _ in range(8):
            rec.observe(M.REPLICA_P99_SECONDS, 2.5, labels=L)
            finalized.extend(ie.observe(eng.evaluate()))
            if ie.opened_total:
                rounds_after_open += 1
            if finalized:
                break
            c.tick(5.0)
        assert len(finalized) == 1
        inc = finalized[0]
        assert rounds_after_open == 3 and inc.status == "finalized"
        assert inc.rule == "replica/r1/p99" and inc.labels == L
        d = inc.to_dict()
        assert [k for k in d["series"] if k.startswith(M.REPLICA_P99_SECONDS)]
        assert any(e["kind"] == "deploy_started" for e in d["events"])
        assert ie.opened_total == 1 and ie.open_incidents() == []
        snap = ie.snapshot()
        assert snap["opened"] == 1 and len(snap["recent"]) == 1
        assert snap["open"] == []
        counts = {s["labels"]["severity"]: s["value"]
                  for s in reg.snapshot()["metrics"]
                  [M.INCIDENTS_TOTAL]["series"]}
        assert counts == {"page": 1.0}
        return d, snap, counts

    _both(scenario)


def test_cooldown_flap_guard_blocks_refire():
    def scenario(T):
        c, rec, j, eng, ie, _ = _wire(T, _p99_rule(T), post_intervals=1,
                                      cooldown_s=10_000.0)
        L = {"replica": "r1"}

        def rounds(v, n):
            for _ in range(n):
                rec.observe(M.REPLICA_P99_SECONDS, v, labels=L)
                ie.observe(eng.evaluate())
                c.tick(5.0)

        rounds(0.05, 6)
        rounds(2.5, 4)
        assert ie.opened_total == 1
        rounds(0.05, 4)
        rounds(2.5, 4)
        assert ie.opened_total == 1 and len(ie.incidents()) == 1
        return ie.snapshot()

    _both(scenario)


def test_capture_freezes_correlated_series_inside_pre_window():
    def scenario(T):
        c, rec, j, eng, ie, _ = _wire(T, _p99_rule(T), pre_window_s=20.0)
        breached = {"replica": "r1"}
        neighbor = {"replica": "r1", "pool": "decode"}
        stranger = {"replica": "r9"}
        for i in range(12):
            rec.observe(M.REPLICA_P99_SECONDS, 0.05 if i < 8 else 2.5,
                        labels=breached)
            rec.observe(M.REPLICA_QUEUE_DEPTH, float(i), labels=neighbor)
            rec.observe(M.REPLICA_QUEUE_DEPTH, 1.0, labels=stranger)
            done = ie.observe(eng.evaluate())
            if done:
                break
            c.tick(5.0)
        inc = done[0].to_dict()
        keys = list(inc["series"])
        assert any(M.REPLICA_P99_SECONDS in k for k in keys)
        assert any(M.REPLICA_QUEUE_DEPTH in k and "decode" in k
                   for k in keys)
        assert not any("r9" in k for k in keys)
        since = inc["opened_at"] - 20.0
        for samples in inc["series"].values():
            assert all(t >= since for t, _v in samples)
        return inc

    _both(scenario)


def test_onset_precedes_firing_edge():
    def scenario(T):
        c, rec, j, eng, ie, _ = _wire(T, _p99_rule(T))
        L = {"replica": "r1"}
        deflect_at, done = None, []
        for i in range(16):
            if i == 10:
                deflect_at = c()
            rec.observe(M.REPLICA_P99_SECONDS, 0.05 if i < 10 else 2.5,
                        labels=L)
            done = ie.observe(eng.evaluate())
            if done:
                break
            c.tick(5.0)
        inc = done[0]
        assert inc.onset_at == deflect_at and inc.onset_at < inc.opened_at
        return inc.onset_at, inc.opened_at

    _both(scenario)


def test_suspect_ranking_scope_beats_fleet_wide_beats_mismatch():
    def scenario(T):
        c, rec, j, eng, ie, _ = _wire(T, _p99_rule(T))
        L = {"replica": "r1"}
        for _ in range(10):
            rec.observe(M.REPLICA_P99_SECONDS, 0.05, labels=L)
            ie.observe(eng.evaluate())
            c.tick(5.0)
        j.record("chaos_inject", "kind=kill", ground_truth=True,
                 replica="r1")
        j.record("membership_change", "incarnation=7")
        j.record("autoscale_up", "scale 2->3", replica="r9", pool="decode")
        done = []
        for _ in range(8):
            rec.observe(M.REPLICA_P99_SECONDS, 2.5, labels=L)
            done = ie.observe(eng.evaluate())
            if done:
                break
            c.tick(5.0)
        suspects = done[0].suspects
        kinds = [s["kind"] for s in suspects]
        assert kinds[0] == "chaos_inject" and suspects[0]["ground_truth"]
        assert kinds.index("membership_change") < kinds.index("autoscale_up")
        scores = [s["score"] for s in suspects]
        assert scores == sorted(scores, reverse=True)
        assert [s["rank"] for s in suspects] == \
            list(range(1, len(suspects) + 1))
        return suspects

    _both(scenario)


def test_trace_provider_is_captured_and_guarded():
    def provider(since, until):
        return [{"trace_id": "t1", "since": since, "until": until}]

    def boom(since, until):
        raise RuntimeError("sampler gone")

    def scenario(T):
        out = []
        for trace_provider, kw in ((provider, {}), (boom,
                                                    {"cooldown_s": 0.0})):
            c, rec, j, eng, ie, _ = _wire(T, _p99_rule(T), **kw)
            ie.trace_provider = trace_provider
            done = []
            for i in range(16):
                rec.observe(M.REPLICA_P99_SECONDS, 0.05 if i < 8 else 2.5,
                            labels={"replica": "r1"})
                done = ie.observe(eng.evaluate())
                if done:
                    break
                c.tick(5.0)
            out.append(done[0].traces)
        assert out[0] and out[0][0]["trace_id"] == "t1"
        assert out[1] == []
        return out

    _both(scenario)


def test_observe_accepts_alert_dicts_and_ignores_non_firing():
    def scenario(T):
        c, rec, j, eng, ie, _ = _wire(T, _p99_rule(T))
        ie.observe([{"rule": "x/y", "state": "resolved", "at": c(),
                     "severity": "page", "labels": {}}])
        assert ie.opened_total == 0
        ie.observe([{"rule": "x/y", "state": "firing", "at": c(),
                     "severity": "ticket", "value": 9.0,
                     "labels": {"replica": "r1"}}])
        assert ie.opened_total == 1
        assert ie.open_incidents()[0].severity == "ticket"
        return ie.snapshot()

    _both(scenario)


# ---------------------------------------------------------------------------
# merge_alerts / merge_incidents cluster folds
# ---------------------------------------------------------------------------

def test_merge_alerts_dedupes_duplicate_rule_host_worst_wins():
    dup = {"alerts": {
        "active": [
            {"rule": "replica/r1/p99", "severity": "ticket", "since": 5.0,
             "labels": {"replica": "r1"}},
            {"rule": "replica/r1/p99", "severity": "page", "since": 9.0,
             "labels": {"replica": "r1"}}],
        "recent": [
            {"rule": "replica/r1/p99", "state": "resolved", "at": 4.0},
            {"rule": "replica/r1/p99", "state": "firing", "at": 4.0},
            {"rule": "replica/r1/p99", "state": "firing", "at": 4.0}]}}
    other = {"alerts": {
        "active": [{"rule": "replica/r1/p99", "severity": "ticket",
                    "since": 2.0}],
        "recent": [{"rule": "replica/r1/p99", "state": "firing",
                    "at": 2.0}]}}

    def scenario(T):
        merged = T.merge_alerts({"h2": other, "h1": dup})
        assert merged["hosts"] == ["h1", "h2"]
        assert [(a["host"], a["severity"]) for a in merged["active"]] == \
            [("h1", "page"), ("h2", "ticket")]
        h1_recent = [a for a in merged["recent"] if a["host"] == "h1"]
        assert len(h1_recent) == 1 and h1_recent[0]["state"] == "firing"
        assert merged["totals"] == {"firing": 2}
        assert merged["verdict"] == "critical"
        assert [a["host"] for a in merged["recent"]] == ["h2", "h1"]
        return merged

    _both(scenario)


def test_merge_alerts_none_when_no_engine_snapshots():
    def scenario(T):
        assert T.merge_alerts({"h1": {"metrics": {}}, "h2": {}}) is None

    _both(scenario)


def _inc(id_, status, opened_at, rule="r/p99"):
    return {"id": id_, "rule": rule, "severity": "page",
            "opened_at": opened_at, "status": status, "labels": {},
            "suspects": [], "events": []}


def test_merge_incidents_host_stamps_dedupes_and_orders():
    p1 = {"incidents": {"open": [_inc("inc-0002", "open", 20.0)],
                        "recent": [_inc("inc-0001", "finalized", 5.0)],
                        "opened": 2}}
    p2 = {"incidents": {"open": [],
                        "recent": [_inc("inc-0001", "finalized", 9.0)],
                        "opened": 1}}

    def scenario(T):
        merged = T.merge_incidents({"h1": p1, "h2": p2})
        assert merged["hosts"] == ["h1", "h2"] and merged["opened"] == 3
        assert [(i["id"], i["host"]) for i in merged["recent"]] == \
            [("inc-0001", "h1"), ("inc-0001", "h2")]
        assert [(i["id"], i["host"]) for i in merged["open"]] == \
            [("inc-0002", "h1")]
        assert T.merge_incidents({"h": {"alerts": {}}}) is None
        return merged

    _both(scenario)


def test_merge_incidents_finalized_republish_supersedes_open():
    p = {"incidents": {"open": [_inc("inc-0001", "open", 5.0)],
                       "recent": [_inc("inc-0001", "finalized", 5.0)],
                       "opened": 1}}

    def scenario(T):
        merged = T.merge_incidents({"h1": p})
        assert merged["open"] == []
        assert [i["status"] for i in merged["recent"]] == ["finalized"]
        return merged

    _both(scenario)


def test_payload_and_merge_cluster_carry_incidents():
    def scenario(T):
        tel = T.Telemetry(registry=T.MetricsRegistry())
        assert tel.payload()["incidents"] is None
        rec = T.MetricRecorder(clock=Clock())
        tel.incidents = T.IncidentEngine(
            rec, journal=T.ChangeJournal(registry=T.MetricsRegistry()),
            registry=T.MetricsRegistry())
        snap = tel.payload()["incidents"]
        assert snap == {"open": [], "recent": [], "opened": 0}
        cluster = T.merge_cluster({"h1": tel.payload()})
        assert cluster["incidents"]["hosts"] == ["h1"]
        return snap, cluster["incidents"]

    _both(scenario)


def test_runtime_registered_families_stay_in_shared_table():
    """Every family the port's live subsystems register at runtime (the
    training bundle and its accountant, the server's metrics, the SLO
    and incident engines, the change journal) is in the port's
    ``METRIC_FAMILY_NAMES``; the two sides register the same families."""
    from bigdl_tpu.serving.metrics import ServingMetrics as JServingMetrics
    from bigdl_tpu_torch.serving.metrics import ServingMetrics
    from bigdl_tpu_torch.telemetry.metric_names import METRIC_FAMILY_NAMES

    def scenario(T):
        reg = T.MetricsRegistry()
        tel = T.Telemetry(registry=reg)
        tel.payload()
        (ServingMetrics if T is ttel else JServingMetrics)(registry=reg)
        rec = T.MetricRecorder(clock=Clock())
        T.SloEngine(rec, registry=reg)
        j = T.ChangeJournal(registry=reg)
        j.record("deploy_started")
        T.IncidentEngine(rec, journal=j, registry=reg)
        return sorted(reg.snapshot()["metrics"])

    registered = set(_both(scenario))
    stray = {f for f in registered if f.startswith("bigdl_")} \
        - set(METRIC_FAMILY_NAMES)
    assert not stray, sorted(stray)


def test_trace_report_buckets_untagged_traces_under_default(monkeypatch):
    """Traces with no tenant stamp land in the ``_default`` bucket — the
    per-tenant attribution never drops wall seconds; the port's report
    equals the JAX repository's tool on the same traces."""
    import bigdl_tpu.serving.request_trace as jrt
    import bigdl_tpu_torch.serving.request_trace as trt
    import tools.trace_report as jreport
    from bigdl_tpu_torch.serving import trace_report as treport

    def fake_attr(trace):
        return {"wall_s": trace["wall_s"],
                "tenant": trace.get("tenant"),
                "phases": {"compute": trace["wall_s"]},
                "compute_by_replica": {"r0": trace["wall_s"]},
                "coverage": 1.0, "critical_phase": "compute",
                "critical_replica": "r0"}

    monkeypatch.setattr(jrt, "trace_attribution", fake_attr)
    monkeypatch.setattr(trt, "trace_attribution", fake_attr)
    traces = {"t1": {"wall_s": 0.5, "tenant": "alpha"},
              "t2": {"wall_s": 0.25},
              "t3": {"wall_s": 0.125, "tenant": None}}
    report = treport.analyze(traces)
    tenants = report["tenants"]
    assert set(tenants) == {"alpha", "_default"}
    assert tenants["_default"]["traces"] == 2
    assert tenants["_default"]["wall_s"] == pytest.approx(0.375)
    total = sum(t["wall_s"] for t in tenants.values())
    assert total == pytest.approx(sum(r["wall_s"] for r in report["rows"]))
    assert report == jreport.analyze(traces)
    assert treport.render(report) == jreport.render(report)
