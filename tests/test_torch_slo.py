"""The port's online health engine (``bigdl_tpu_torch/telemetry/
timeseries.py`` + ``slo.py`` and ``LocalOptimizer``'s health hook)
against the JAX package's, on the CPU.

Every spec of ``tests/test_slo.py`` whose module the port has is
mirrored: the same samples, on the same injected clock, go through the
JAX object and its port counterpart, each scenario makes the reference's
assertions on both, and the two sides' readings — reducer values,
alert transitions, verdicts, snapshots — must be equal.  The
autoscaler and fleet specs (``test_autoscaler_*``, ``test_router_*``,
``test_fleet_health_monitor_*``) run both packages' ``Autoscaler`` and
``ServingFleet`` the same way (``tests/_torch_fleet_sides.py``; each
fleet stopped in ``finally`` under a deadline of its own).
"""
import dataclasses

import numpy as np
import pytest
import torch

import bigdl_tpu.telemetry as jtel
import bigdl_tpu_torch.telemetry as ttel
from bigdl_tpu_torch.telemetry import metric_names as M

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


def _both(scenario):
    """Run ``scenario(package)`` on the JAX telemetry package and on the
    port's; their readings must be equal.  Returns the port's."""
    got = {name: scenario(pkg) for name, pkg in PACKAGES.items()}
    assert got["port"] == got["jax"]
    return got["port"]


def _alerts(alerts):
    return [dataclasses.asdict(a) for a in alerts]


def test_metric_names_table_is_the_reference_table():
    from bigdl_tpu.telemetry import metric_names as JM

    names = [n for n in dir(JM) if n.isupper()]
    assert names == [n for n in dir(M) if n.isupper()]
    assert all(getattr(JM, n) == getattr(M, n) for n in names)


# ---------------------------------------------------------------------------
# recorder: rings, reducers, staleness, counter-reset tolerance
# ---------------------------------------------------------------------------

def test_recorder_ring_is_bounded_and_windowed():
    def scenario(T):
        clk = Clock()
        r = T.MetricRecorder(capacity=8, clock=clk)
        for i in range(50):
            clk.t = float(i)
            r.observe("bigdl_train_loss", float(i))
        s = r.series("bigdl_train_loss")
        assert len(s) == 8
        assert s.last() == (49.0, 49.0)
        lo = r.reduce("bigdl_train_loss", "min", window_s=3.0, now=49.0)
        mean = r.reduce("bigdl_train_loss", "mean", window_s=1.0, now=49.0)
        assert lo == 46.0 and mean == pytest.approx(48.5)
        return len(s), s.last(), lo, mean

    _both(scenario)


def test_counter_rate_tolerates_resets():
    def scenario(T):
        clk = Clock()
        r = T.MetricRecorder(clock=clk)
        for t, v in [(0, 0), (1, 10), (2, 20), (3, 5), (4, 15)]:
            clk.t = float(t)
            r.observe("bigdl_serving_requests_total", v, kind="counter")
        delta = r.reduce("bigdl_serving_requests_total", "delta",
                         window_s=100, now=4.0)
        rate = r.reduce("bigdl_serving_requests_total", "rate",
                        window_s=100, now=4.0)
        for t, v in [(0, 0), (1, 10), (2, 20), (3, 5), (4, 15)]:
            r.observe("bigdl_perf_mfu", v, now=float(t))
        gauge = r.reduce("bigdl_perf_mfu", "delta", window_s=100, now=4.0)
        assert (delta, gauge) == (35.0, 15.0)
        assert rate == pytest.approx(8.75)
        return delta, rate, gauge

    _both(scenario)


def test_counter_window_includes_boundary_sample():
    def scenario(T):
        clk = Clock()
        r = T.MetricRecorder(clock=clk)
        for t, v in [(0, 100), (10, 200), (20, 300)]:
            clk.t = float(t)
            r.observe("bigdl_replica_requests_total", v, kind="counter")
        rate = r.reduce("bigdl_replica_requests_total", "rate",
                        window_s=8.0, now=20.0)
        assert rate == pytest.approx(10.0)
        return rate

    _both(scenario)


def test_recorder_staleness_age_and_slope_and_mad():
    def scenario(T):
        clk = Clock()
        r = T.MetricRecorder(clock=clk)
        assert r.age("bigdl_train_loss") is None
        for i in range(10):
            clk.t = float(i)
            r.observe("bigdl_train_loss", 10.0 - i)
        clk.t = 30.0
        out = [r.age("bigdl_train_loss"),
               r.fresh("bigdl_train_loss", max_age_s=5.0),
               r.fresh("bigdl_train_loss", max_age_s=30.0),
               r.reduce("bigdl_train_loss", "slope", window_s=100, now=9.0)]
        assert out[0] == pytest.approx(21.0)
        assert out[1:3] == [False, True]
        assert out[3] == pytest.approx(-1.0)
        r.observe("bigdl_train_loss", 100.0, now=9.5)
        out.append(r.reduce("bigdl_train_loss", "slope", window_s=100,
                            now=9.5))
        assert out[-1] < 0
        for i in range(8):
            r.observe("bigdl_train_step_time_seconds", 0.1, now=float(i))
        r.observe("bigdl_train_step_time_seconds", 0.5, now=8.0)
        out.append(r.reduce("bigdl_train_step_time_seconds", "mad_score",
                            window_s=100, now=8.0))
        assert out[-1] == float("inf")
        return out

    _both(scenario)


def test_recorder_samples_registry_and_merged_views():
    def scenario(T):
        clk = Clock()
        reg = T.MetricsRegistry()
        reg.counter("bigdl_serving_requests_total", labels=("status",)) \
            .labels(status="ok").inc(5)
        h = reg.histogram("bigdl_serving_latency_seconds", window=16)
        for v in (0.01, 0.02, 0.03):
            h.observe(v)
        r = T.MetricRecorder(registry=reg, clock=clk)
        r.sample()
        out = [r.reduce("bigdl_serving_requests_total", "last",
                        labels={"status": "ok"}, window_s=10),
               r.reduce("bigdl_serving_latency_seconds", "last",
                        field="count", window_s=10),
               r.reduce("bigdl_serving_latency_seconds", "last",
                        field="p99", window_s=10)]
        assert out[:2] == [5.0, 3.0] and out[2] is not None
        snap = reg.snapshot()["metrics"]
        merged = T.merge_metrics([snap, snap])
        r2 = T.MetricRecorder(clock=clk)
        r2.sample_metrics(merged)
        out.append(r2.reduce("bigdl_serving_requests_total", "last",
                             labels={"status": "ok"}, window_s=10))
        assert out[-1] == 10.0
        return out

    _both(scenario)


# ---------------------------------------------------------------------------
# engine: lifecycle, staleness gate, burn-rate interplay
# ---------------------------------------------------------------------------

def _engine(T, rules, clk):
    r = T.MetricRecorder(clock=clk)
    return r, T.SloEngine(r, rules=rules, registry=T.MetricsRegistry(),
                          clock=clk)


def test_threshold_firing_resolved_lifecycle_and_counters():
    def scenario(T):
        clk = Clock()
        rule = T.SloRule(name="serving/both/p99",
                         family=M.AUTOSCALE_POOL_P99_SECONDS,
                         labels={"pool": "both"}, kind="threshold",
                         reduce="last", op=">=", threshold=0.5,
                         window_s=10.0, for_intervals=2, resolve_intervals=2)
        r, eng = _engine(T, [rule], clk)

        def step(v):
            clk.tick()
            r.observe(M.AUTOSCALE_POOL_P99_SECONDS, v,
                      labels={"pool": "both"})
            return _alerts(eng.evaluate())

        seq = [step(v) for v in (0.1, 0.9, 0.9)]
        assert seq[:2] == [[], []]
        assert [a["state"] for a in seq[2]] == ["firing"]
        assert seq[2][0]["severity"] == "page"
        assert eng.verdict().status == "critical"
        assert eng.active_alerts()[0]["rule"] == "serving/both/p99"
        seq += [step(v) for v in (0.9, 0.1, 0.1)]
        assert seq[3:5] == [[], []]
        assert [a["state"] for a in seq[5]] == ["resolved"]
        assert eng.verdict().status == "ok" and eng.verdict().healthy
        counts = {s["labels"]["state"]: s["value"]
                  for s in eng.registry.snapshot()["metrics"]
                  [M.ALERTS_TOTAL]["series"]}
        assert counts == {"firing": 1.0, "resolved": 1.0}
        assert eng.registry.get(M.ALERTS_ACTIVE).value == 0.0
        return seq, counts, eng.snapshot()

    _both(scenario)


def test_staleness_gate_freezes_state_no_verdict():
    def scenario(T):
        clk = Clock()
        rule = T.SloRule(name="serving/both/p99",
                         family=M.AUTOSCALE_POOL_P99_SECONDS,
                         kind="threshold", reduce="last", op=">=",
                         threshold=0.5, window_s=5.0, staleness_s=3.0,
                         for_intervals=1, resolve_intervals=1)
        r, eng = _engine(T, [rule], clk)
        clk.tick()
        r.observe(M.AUTOSCALE_POOL_P99_SECONDS, 0.9)
        seq = [_alerts(eng.evaluate())]
        assert [a["state"] for a in seq[0]] == ["firing"]
        for _ in range(5):
            clk.tick(2.0)
            seq.append(_alerts(eng.evaluate()))
            assert seq[-1] == []
        assert eng.verdict().status == "critical"
        r.observe(M.AUTOSCALE_POOL_P99_SECONDS, 0.1)
        seq.append(_alerts(eng.evaluate()))
        assert [a["state"] for a in seq[-1]] == ["resolved"]
        return seq

    _both(scenario)


def test_burn_rate_fast_slow_window_interplay():
    def scenario(T):
        clk = Clock()
        L = {"pool": "both"}
        rule = T.SloRule(name="serving/both/error_budget",
                         family=M.AUTOSCALE_POOL_SHED_TOTAL, labels=L,
                         total_family=M.AUTOSCALE_POOL_REQUESTS_TOTAL,
                         total_labels=L, kind="burn_rate", budget=0.05,
                         fast_window_s=10.0, slow_window_s=60.0,
                         burn_factor=2.0, for_intervals=1,
                         resolve_intervals=1)
        r, eng = _engine(T, [rule], clk)
        count = {"shed": 0, "total": 0}

        def step(bad, good):
            clk.tick()
            count["shed"] += bad
            count["total"] += bad + good
            r.observe(M.AUTOSCALE_POOL_SHED_TOTAL, count["shed"], labels=L,
                      kind="counter")
            r.observe(M.AUTOSCALE_POOL_REQUESTS_TOTAL, count["total"],
                      labels=L, kind="counter")
            return _alerts(eng.evaluate())

        for _ in range(60):
            assert step(0, 100) == []
        for _ in range(3):
            assert step(100, 0) == []
        assert eng.verdict().status == "ok"
        for _ in range(20):
            step(0, 100)
        fired = sum((step(100, 0) for _ in range(12)), [])
        assert [a["state"] for a in fired] == ["firing"]
        assert eng.verdict().status == "critical"
        resolved = sum((step(0, 100) for _ in range(12)), [])
        assert [a["state"] for a in resolved] == ["resolved"]
        return fired, resolved

    _both(scenario)


def test_absent_rule_is_the_dead_man_switch():
    def scenario(T):
        clk = Clock()
        rule = T.SloRule(name="replica/r1/health_feed",
                         family=M.REPLICA_P99_SECONDS,
                         labels={"replica": "r1"}, kind="absent",
                         window_s=3.0, for_intervals=1, resolve_intervals=1)
        r, eng = _engine(T, [rule], clk)
        clk.tick(10.0)
        seq = [_alerts(eng.evaluate())]
        r.observe(M.REPLICA_P99_SECONDS, 0.01, labels={"replica": "r1"})
        seq.append(_alerts(eng.evaluate()))
        clk.tick(5.0)
        seq.append(_alerts(eng.evaluate()))
        r.observe(M.REPLICA_P99_SECONDS, 0.01, labels={"replica": "r1"})
        seq.append(_alerts(eng.evaluate()))
        assert seq[:2] == [[], []]
        assert [[a["state"] for a in s] for s in seq[2:]] == \
            [["firing"], ["resolved"]]
        return seq

    _both(scenario)


def test_anomaly_rule_step_time_drift():
    def scenario(T):
        clk = Clock()
        rule = T.SloRule(name="training/step_time_drift",
                         family=M.TRAIN_STEP_TIME_SECONDS, kind="anomaly",
                         score=6.0, direction="up", window_s=100.0,
                         for_intervals=2, resolve_intervals=2, min_samples=8)
        r, eng = _engine(T, [rule], clk)
        for i in range(16):
            clk.tick()
            r.observe(M.TRAIN_STEP_TIME_SECONDS, 0.100 + 0.001 * (i % 3))
            assert eng.evaluate() == []
        fired = []
        for _ in range(3):
            clk.tick()
            r.observe(M.TRAIN_STEP_TIME_SECONDS, 0.4)
            fired += _alerts(eng.evaluate())
        assert [a["state"] for a in fired] == ["firing"]
        return fired

    _both(scenario)


# ---------------------------------------------------------------------------
# the chaos e2e and its steady control
# ---------------------------------------------------------------------------

def _chaos_rules(T):
    rules = T.default_serving_rules(
        "both", p99_high_s=0.5, shed_high=0.05, error_budget=0.02,
        window_s=30.0, fast_window_s=15.0, slow_window_s=60.0,
        for_intervals=2, resolve_intervals=2)
    rules += T.default_training_rules(
        goodput_floor=0.5, loss_window_s=60.0, divergence_ratio=1.5,
        mfu_drop_frac=0.5, window_s=60.0, for_intervals=2,
        resolve_intervals=2)
    rules = [r for r in rules if r.name != "training/loss_stall"]
    rules.append(T.SloRule(
        name="replica/r1/health_feed", family=M.REPLICA_P99_SECONDS,
        labels={"replica": "r1"}, kind="absent", window_s=12.0,
        resolve_intervals=1, description="replica r1 health feed went silent"))
    return rules


class _ChaosHarness:
    """``tests/test_slo.py``'s scripted fleet + training signals: one
    tick = one evaluation interval (5 s)."""

    INTERVAL = 5.0

    def __init__(self, T):
        self.clk = Clock()
        self.r = T.MetricRecorder(clock=self.clk)
        self.eng = T.SloEngine(self.r, rules=_chaos_rules(T),
                               registry=T.MetricsRegistry(), clock=self.clk)
        self.shed = self.total = 0
        self.loss, self.mfu = 4.0, 0.5

    def tick(self, *, shed_frac=0.0, diverge=False, kill_replica=False,
             mfu=None):
        self.clk.tick(self.INTERVAL)
        L, r, n = {"pool": "both"}, self.r, 500
        self.shed += int(n * shed_frac)
        self.total += n
        r.observe(M.AUTOSCALE_POOL_P99_SECONDS, 0.040, labels=L)
        r.observe(M.AUTOSCALE_POOL_SHED_RATE, shed_frac, labels=L)
        r.observe(M.AUTOSCALE_POOL_KV_OCCUPANCY, 0.3, labels=L)
        r.observe(M.AUTOSCALE_POOL_SHED_TOTAL, self.shed, labels=L,
                  kind="counter")
        r.observe(M.AUTOSCALE_POOL_REQUESTS_TOTAL, self.total, labels=L,
                  kind="counter")
        self.loss = self.loss * (1.8 if diverge else 0.98)
        r.observe(M.TRAIN_LOSS, self.loss)
        r.observe(M.TRAIN_STEP_TIME_SECONDS, 0.1)
        r.observe(M.GOODPUT_PRODUCTIVE_FRACTION, 0.97)
        if mfu is not None:
            self.mfu = mfu
        r.observe(M.PERF_MFU, self.mfu)
        if not kill_replica:
            r.observe(M.REPLICA_P99_SECONDS, 0.02, labels={"replica": "r1"})
        return _alerts(self.eng.evaluate())


def test_chaos_e2e_detects_each_breach_within_3_intervals():
    def scenario(T):
        h = _ChaosHarness(T)
        log = []
        for _ in range(20):
            assert h.tick() == []

        def fire_within(n, **kw):
            for i in range(1, n + 1):
                alerts = h.tick(**kw)
                log.append(alerts)
                rules = [a["rule"] for a in alerts if a["state"] == "firing"]
                if rules:
                    return i, rules
            raise AssertionError(f"no alert within {n} intervals for {kw}")

        def resolve_within(n, rules, **kw):
            resolved = []
            for _ in range(n):
                alerts = h.tick(**kw)
                log.append(alerts)
                resolved += [a["rule"] for a in alerts
                             if a["state"] == "resolved"]
                if set(rules) <= set(resolved):
                    return
            raise AssertionError(f"{rules} did not resolve: {resolved}")

        took, rules = fire_within(3, shed_frac=0.30)
        assert took <= 3 and "serving/both/shed_rate" in rules
        for _ in range(4):
            log.append(h.tick(shed_frac=0.30))
        assert "serving/both/error_budget" in {
            a["rule"] for a in h.eng.active_alerts()}
        resolve_within(16, ["serving/both/shed_rate",
                            "serving/both/error_budget"])
        took, rules = fire_within(3, diverge=True)
        assert took <= 3 and "training/loss_divergence" in rules
        for _ in range(30):
            log.append(h.tick())
            if not h.eng.firing(["training/loss_divergence"]):
                break
        assert not h.eng.firing(["training/loss_divergence"])
        took, rules = fire_within(3, mfu=0.1)
        assert took <= 3 and "training/mfu_collapse" in rules
        resolve_within(30, ["training/mfu_collapse"], mfu=0.5)
        took, rules = fire_within(3, kill_replica=True)
        assert took <= 3 and "replica/r1/health_feed" in rules
        resolve_within(3, ["replica/r1/health_feed"])
        assert h.eng.verdict().status == "ok"
        return log

    _both(scenario)


def test_chaos_steady_control_zero_false_positives():
    def scenario(T):
        h = _ChaosHarness(T)
        alerts = sum((h.tick() for _ in range(200)), [])
        assert alerts == [] and h.eng.verdict().status == "ok"
        snap = h.eng.snapshot()
        assert snap["active"] == [] and snap["verdict"] == "ok"
        return snap

    _both(scenario)


# ---------------------------------------------------------------------------
# training health monitor + the driver hook
# ---------------------------------------------------------------------------

def test_training_monitor_verdict_flips_on_divergence():
    def scenario(T):
        clk = Clock()
        mon = T.TrainingHealthMonitor(
            rules=T.default_training_rules(for_intervals=2,
                                           resolve_intervals=2,
                                           loss_window_s=60.0),
            every_n_steps=1, registry=T.MetricsRegistry(), clock=clk)
        loss = 4.0
        for i in range(20):
            clk.tick()
            loss *= 0.95
            mon.on_step(i, loss, 0.1)
        assert mon.verdict().healthy
        for i in range(20, 26):
            clk.tick()
            loss *= 2.0
            mon.on_step(i, loss, 0.1)
        v = mon.verdict()
        assert v.status == "critical"
        assert "training/loss_divergence" in v.firing
        mon.on_step(26, float("nan"), 0.1)
        last = mon.recorder.reduce(M.TRAIN_LOSS, "last", window_s=1e9)
        assert last == loss
        return v.status, list(v.firing), last, mon.snapshot()

    _both(scenario)


def _regression(n=64, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 8).astype(np.float32)
    w = rng.rand(8, 1).astype(np.float32)
    return x, (x @ w).astype(np.float32)


def test_optimizer_health_hook_feeds_monitor():
    """The driver hook on both packages' LocalOptimizer: the monitor is
    fed every iteration, adopts the optimizer's bundle at attach time,
    answers a live verdict, and rides the telemetry payload."""
    from bigdl_tpu import nn as jnn
    from bigdl_tpu.dataset import Sample as JSample
    from bigdl_tpu.dataset import array as jarray
    from bigdl_tpu.optim import SGD as JSGD
    from bigdl_tpu.optim import max_iteration as jmax
    from bigdl_tpu.optim.optimizer import LocalOptimizer as JLocal
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import Sample, array
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, max_iteration

    x, y = _regression()

    def run(T, opt):
        opt.set_end_when((jmax if T is jtel else max_iteration)(12))
        tm = T.Telemetry(registry=T.MetricsRegistry())
        opt.set_telemetry(tm)
        mon = T.TrainingHealthMonitor(
            rules=[r for r in T.default_training_rules()
                   if r.name == "training/loss_divergence"],
            every_n_steps=2)
        opt.set_health_monitor(mon)
        assert mon.telemetry is tm and tm.slo is mon.engine
        opt.optimize()
        v = opt.health_verdict()
        assert v is not None and v.healthy, v
        payload = tm.payload(step=12)
        assert payload["alerts"]["verdict"] == "ok"
        return (len(mon.recorder.series(M.TRAIN_LOSS)) >= 12, v.status,
                payload["alerts"]["active"])

    jopt = JLocal(jnn.Sequential(jnn.Linear(8, 8), jnn.Tanh(),
                                 jnn.Linear(8, 1)),
                  jarray([JSample(a, b) for a, b in zip(x, y)]),
                  jnn.MSECriterion(), batch_size=32)
    jopt.set_optim_method(JSGD(learning_rate=0.05))
    g = torch.Generator().manual_seed(0)
    topt = LocalOptimizer(
        nn.Sequential(nn.Linear(8, 8, device="cpu", generator=g),
                      nn.Tanh(device="cpu"),
                      nn.Linear(8, 1, device="cpu", generator=g),
                      device="cpu"),
        array([Sample(a, b) for a, b in zip(x, y)]), nn.MSECriterion(),
        batch_size=32)
    topt.set_optim_method(SGD(learning_rate=0.05))
    assert run(ttel, topt) == run(jtel, jopt) == (True, "ok", [])
    assert LocalOptimizer(topt.model, topt.dataset,
                          topt.criterion).health_verdict() is None


# ---------------------------------------------------------------------------
# autoscaler: SLO verdicts reproduce raw-threshold decisions
# ---------------------------------------------------------------------------

class _StubServer:
    def __init__(self, role):
        self.role = role


class _StubRouter:
    def __init__(self, side):
        self.metrics = side.serving.ServingMetrics()
        self.health = {}

    def health_of(self, rid):
        return self.health.get(rid)


class _StubFleet:
    """Just enough fleet for the Autoscaler: scripted health
    snapshots, recorded add/remove calls."""

    def __init__(self, side, roles):
        self.servers = {rid: _StubServer(role)
                        for rid, role in roles.items()}
        self.router = _StubRouter(side)
        self.actions = []

    def add_replica(self, rid, server):
        self.servers[rid] = server
        self.actions.append(("add", rid))

    def remove_replica(self, rid, timeout=None, drain=True):
        self.servers.pop(rid, None)
        self.router.health.pop(rid, None)
        self.actions.append(("remove", rid))
        return True


def _scripted_rounds():
    """quiet -> sustained p99 breach -> recovery -> idle drain -> a
    one-sample blip that must scale nothing."""
    quiet = {"ready": True, "role": "both", "p99_s": 0.02,
             "queue_depth": 0, "shed_total": 0, "requests_total": 0}
    rounds = []
    req = 0
    for spec in ([dict(p99=0.02, dreq=50)] * 3
                 + [dict(p99=2.0, dreq=200)] * 4
                 + [dict(p99=0.02, dreq=50)] * 2
                 + [dict(p99=0.01, dreq=50)] * 6
                 + [dict(p99=3.0, dreq=200)]
                 + [dict(p99=0.01, dreq=50)] * 4):
        req += spec["dreq"]
        rounds.append(dict(quiet, p99_s=spec["p99"], requests_total=req))
    return rounds


def _drive(side, signal_source):
    clk = Clock()
    fleet = _StubFleet(side, {"r0": "both"})
    policy = side.autoscale.AutoscalePolicy(
        min_replicas=1, max_replicas=3, p99_high_s=0.5, sustain=2,
        p99_idle_s=0.05, idle_sustain=3, cooldown_s=0.0,
        idle_requests_delta=0)
    asc = side.autoscale.Autoscaler(
        fleet, lambda rid, role: _StubServer(role), policy=policy,
        signal_source=signal_source, clock=clk)
    decisions = []
    for h in _scripted_rounds():
        clk.tick()
        fleet.router.health = {rid: dict(h) for rid in fleet.servers}
        for d in asc.evaluate_once():
            decisions.append((d["pool"], d["direction"]))
    return asc, fleet, decisions


def test_autoscaler_slo_reproduces_raw_decisions():
    from _torch_fleet_sides import both

    def scenario(side):
        asc_raw, fleet_raw, raw = _drive(side, "raw")
        asc_slo, fleet_slo, slo = _drive(side, "slo")
        assert raw == slo
        assert fleet_raw.actions == fleet_slo.actions
        assert ("both", "up") in raw and ("both", "down") in raw
        assert asc_slo.slo_engine is not None
        states = [a["state"] for a in asc_slo.slo_engine.snapshot()
                  ["recent"]]
        assert "firing" in states and "resolved" in states
        assert asc_raw.slo_engine is None
        return {"decisions": raw, "actions": fleet_slo.actions,
                "states": states}
    both(scenario)


def test_autoscaler_slo_traffic_gate_is_staleness():
    from _torch_fleet_sides import both

    def scenario(side):
        clk = Clock()
        fleet = _StubFleet(side, {"r0": "both"})
        policy = side.autoscale.AutoscalePolicy(
            min_replicas=1, max_replicas=3, p99_high_s=0.5, sustain=1,
            cooldown_s=0.0, idle_requests_delta=0)
        asc = side.autoscale.Autoscaler(
            fleet, lambda rid, role: _StubServer(role), policy=policy,
            signal_source="slo", clock=clk)
        fleet.router.health = {"r0": {
            "ready": True, "role": "both", "p99_s": 9.9,
            "queue_depth": 0, "shed_total": 0, "requests_total": 0}}
        for _ in range(4):
            clk.tick()
            assert asc.evaluate_once() == []
        assert fleet.actions == []
        return fleet.actions
    both(scenario)


# ---------------------------------------------------------------------------
# fleet integration: degradation marks ride the eject machinery
# ---------------------------------------------------------------------------

def test_router_degraded_mark_ejects_and_clears():
    from _torch_fleet_sides import SpecDeadline, both

    def scenario(side):
        with SpecDeadline(90) as dl:
            fl = dl.add(side.serving.ServingFleet.build(
                side.small_model(), n_replicas=3,
                server_kw=dict(max_batch=8), heartbeat_timeout=0.4,
                pump_interval_s=0))
            fl.start()
            try:
                assert set(fl.router.members) == {"r0", "r1", "r2"}
                fl.router.mark_degraded("r1", "replica/r1/p99")
                assert "r1" not in fl.router.live()
                fl.pump_once()
                assert "r1" not in fl.router.members
                assert fl.router.degraded == {"r1": "replica/r1/p99"}
                fl.pump_once()
                assert "r1" not in fl.router.members
                rng = np.random.RandomState(0)
                res = fl.submit(rng.rand(4).astype(np.float32)).result(60)
                assert res.ok
                fl.router.clear_degraded("r1")
                fl.pump_once()
                assert "r1" in fl.router.members
                assert "r1" in fl.router.live()
                assert fl.router.snapshot()["degraded"] == {}
                return {"output": res.output,
                        "members": fl.router.members,
                        "ejections": fl.router.ejections}
            finally:
                fl.stop(10)
    both(scenario)


def test_fleet_health_monitor_marks_slow_replica_degraded():
    import json as _json

    from _torch_fleet_sides import SpecDeadline, both

    def scenario(side):
        with SpecDeadline(90) as dl:
            fl = dl.add(side.serving.ServingFleet.build(
                side.small_model(), n_replicas=3,
                server_kw=dict(max_batch=8),
                heartbeat_timeout=5.0, pump_interval_s=0, health=True,
                health_kw=dict(policy=side.serving.ReplicaHealthPolicy(
                    p99_high_s=0.5, window_s=30.0, feed_dead_s=30.0,
                    for_intervals=2, resolve_intervals=2))))
            fl.start()
            try:
                mon = fl.health_monitor
                assert mon is not None

                def publish(rid, p99, ts):
                    h = {"replica": rid, "ready": True, "healthy": True,
                         "draining": False, "queue_depth": 0,
                         "breaker_state": "closed", "role": "both",
                         "p99_s": p99, "served_ok": 100,
                         "shed_total": 0, "requests_total": 100,
                         "ts": ts}
                    fl.transport.put(side.router.HEALTH_PREFIX + rid,
                                     _json.dumps(h))

                for i in range(3):
                    for rid in ("r0", "r1", "r2"):
                        publish(rid, 2.0 if rid == "r1" else 0.01,
                                ts=1000.0 + i)
                    fl.router.refresh()
                    mon.observe()
                assert "r1" in fl.router.degraded
                assert "r1" in mon.degraded()
                fl.router.refresh()
                assert "r1" not in fl.router.members
                snap = fl.snapshot()
                assert snap["health"]["degraded"]
                assert "bigdl_alerts_total" in snap["metrics"]
                marked = sorted(fl.router.degraded)
                for i in range(3):
                    for rid in ("r0", "r1", "r2"):
                        publish(rid, 0.01, ts=2000.0 + i)
                    fl.router.refresh()
                    mon.observe()
                assert "r1" not in fl.router.degraded
                fl.pump_once()
                assert "r1" in fl.router.members
                return {"marked": marked,
                        "degraded": snap["health"]["degraded"],
                        "members": fl.router.members}
            finally:
                fl.stop(10)
    both(scenario)
