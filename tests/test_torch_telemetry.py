"""The port's telemetry spine (``bigdl_tpu_torch/telemetry/``: registry,
tracer, goodput ledger, the ``Telemetry`` bundle, the cluster fold and
the run report, ``TelemetrySummary``) and its wiring into
``LocalOptimizer`` and ``DistriOptimizer``, against the JAX package's,
on the CPU.

Every spec of ``tests/test_telemetry.py`` whose module the port has is
mirrored: the same events, on the same injected clock, go through the
JAX object and its port counterpart; each scenario makes the
reference's assertions on both, and the two sides' registry snapshots,
Prometheus text, ledger snapshots, Chrome traces, folds and reports
must be equal.  The drivers are held against the JAX ones on what both
count (steps, records, compile and step spans, checkpoints); the port's
losses and weights with telemetry against its own without, bit for bit.
``DistriOptimizer`` runs as 2 gloo ranks of
``tests/_torch_distri_child.py`` under a deadline that kills them.

Not mirrored here: ``tools/run_report.py`` (the JAX bench's tool), the
4-host chaos acceptance run and the watchdog half of the default-
registry spec (the elastic layer, ROADMAP Queue 1 item 7).
"""
import itertools
import json
import os
import pickle
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_distri_child as child
import bigdl_tpu.telemetry as jtel
import bigdl_tpu.telemetry.report  # noqa: F401 (T.report below)
import bigdl_tpu_torch.telemetry as ttel
import bigdl_tpu_torch.telemetry.report  # noqa: F401
from bigdl_tpu_torch.telemetry.registry import Histogram, default_buckets

torch.set_num_threads(1)

PACKAGES = {"jax": jtel, "port": ttel}
REPO = Path(__file__).resolve().parents[1]
LAUNCH_TIMEOUT_S = 120


def _fake_clock(start=0.0, tick=1.0):
    counter = itertools.count()
    return lambda: start + tick * next(counter)


def _both(scenario):
    """Run ``scenario(package)`` on the JAX telemetry package and on the
    port's; their readings must be equal.  Returns the port's."""
    got = {name: scenario(pkg) for name, pkg in PACKAGES.items()}
    assert got["port"] == got["jax"]
    return got["port"]


class KV:
    """A key-value transport with ``InMemoryKV``'s methods (the port's
    elastic layer, which has one, is not ported yet)."""

    def __init__(self):
        self._d, self._lock = {}, threading.Lock()

    def put(self, key, value):
        with self._lock:
            self._d[key] = value

    def get(self, key):
        with self._lock:
            return self._d.get(key)

    def keys(self, prefix=""):
        with self._lock:
            return sorted(k for k in self._d if k.startswith(prefix))

    def delete(self, key):
        with self._lock:
            self._d.pop(key, None)


# ---------------------------------------------------------------------------
# registry: counters, gauges, histograms
# ---------------------------------------------------------------------------

def test_counter_gauge_labels_and_snapshot_json():
    def scenario(T):
        r = T.MetricsRegistry(clock=lambda: 42.0)
        c = r.counter("req_total", "requests", labels=("status",))
        c.labels(status="ok").inc()
        c.labels(status="ok").inc(2)
        c.labels(status="shed").inc()
        r.gauge("depth", "queue depth").set(7)
        snap = json.loads(json.dumps(r.snapshot()))
        assert snap["ts"] == 42.0
        series = {tuple(s["labels"].items()): s["value"]
                  for s in snap["metrics"]["req_total"]["series"]}
        assert series[(("status", "ok"),)] == 3.0
        assert series[(("status", "shed"),)] == 1.0
        assert snap["metrics"]["depth"]["series"][0]["value"] == 7.0
        return snap, r.to_prometheus()

    _both(scenario)


def test_counter_rejects_negative_and_reregistration_conflicts():
    def scenario(T):
        r = T.MetricsRegistry()
        c = r.counter("a_total", "a")
        with pytest.raises(ValueError):
            c.inc(-1)
        assert r.counter("a_total", "a") is c
        with pytest.raises(ValueError):
            r.gauge("a_total")
        with pytest.raises(ValueError):
            r.counter("a_total", labels=("x",))
        return r.snapshot()["metrics"]

    _both(scenario)


def test_histogram_window_quantiles_match_numpy_exactly():
    vals = np.random.RandomState(0).exponential(0.05, size=300).tolist()

    def scenario(T):
        h = T.registry.Histogram(window=512)
        for v in vals:
            h.observe(v)
        qs = [h.quantile(q) for q in (0.0, 0.5, 0.9, 0.99, 1.0)]
        assert qs == [float(np.percentile(vals, 100 * q))
                      for q in (0.0, 0.5, 0.9, 0.99, 1.0)]
        return qs

    _both(scenario)


def test_histogram_bucket_quantile_without_window_is_sane():
    def scenario(T):
        h = T.registry.Histogram(bounds=T.default_buckets(1e-3, 2.0, 16))
        for v in [0.01] * 50 + [0.1] * 50:
            h.observe(v)
        qs = [h.quantile(0.5), h.quantile(1.0), h.quantile(0.0)]
        assert 0.008 <= qs[0] <= 0.11
        assert qs[1] == pytest.approx(0.1) and qs[2] >= 0.0
        return qs

    _both(scenario)


def test_histogram_merge_is_associative_and_checks_geometry():
    rng = np.random.RandomState(1)
    samples = [rng.rand(64) * s for s in (1.0, 10.0, 0.01)]

    def scenario(T):
        a, b, c = (T.registry.Histogram() for _ in range(3))
        for h, vals in zip((a, b, c), samples):
            for v in vals:
                h.observe(v)
        left, right = a.merge(b).merge(c), a.merge(b.merge(c))
        assert left.buckets == right.buckets
        assert left.count == right.count == 192
        assert left.sum == pytest.approx(right.sum)
        assert left.min == right.min and left.max == right.max
        with pytest.raises(ValueError):
            a.merge(T.registry.Histogram(bounds=(1.0, 2.0)))
        return left.buckets, left.count, left.min, left.max

    _both(scenario)


def test_prometheus_text_roundtrips_through_minimal_parser():
    def scenario(T):
        r = T.MetricsRegistry()
        r.counter("req_total", "total requests",
                  labels=("status",)).labels(status="ok").inc(5)
        r.gauge("depth", "queue depth").set(3)
        h = r.histogram("lat_seconds", "latency", bounds=(0.1, 1.0, 10.0))
        for v in (0.05, 0.5, 5.0, 50.0):
            h.observe(v)
        return r.to_prometheus()

    text = _both(scenario)
    types, samples = {}, {}
    for line in text.strip().splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            types[name] = kind
        elif not line.startswith("#"):
            m = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
                         r"(\{[^}]*\})?\s+(\S+)$", line)
            assert m, f"unparsable sample line: {line!r}"
            name, labels, value = m.groups()
            samples[(name, labels or "")] = float(value)
    assert types == {"req_total": "counter", "depth": "gauge",
                     "lat_seconds": "histogram"}
    assert samples[("req_total", '{status="ok"}')] == 5.0
    assert samples[("depth", "")] == 3.0
    assert samples[("lat_seconds_bucket", '{le="0.1"}')] == 1.0
    assert samples[("lat_seconds_bucket", '{le="1.0"}')] == 2.0
    assert samples[("lat_seconds_bucket", '{le="10.0"}')] == 3.0
    assert samples[("lat_seconds_bucket", '{le="+Inf"}')] == 4.0
    assert samples[("lat_seconds_count", "")] == 4.0
    assert samples[("lat_seconds_sum", "")] == pytest.approx(55.55)


def test_registry_thread_hammer_loses_nothing():
    r = ttel.MetricsRegistry()
    c = r.counter("hits_total")
    h = r.histogram("obs_seconds", window=64)
    n, threads = 2000, 8

    def work():
        for i in range(n):
            c.inc()
            h.observe(i * 1e-4)

    ts = [threading.Thread(target=work) for _ in range(threads)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    assert c.value == n * threads and h.count == n * threads


# ---------------------------------------------------------------------------
# tracer: nesting, chrome trace export, ring bound
# ---------------------------------------------------------------------------

def test_tracer_nested_spans_and_chrome_trace_valid():
    def scenario(T):
        tr = T.Tracer(clock=_fake_clock())
        with tr.span("step", "step", step=3) as outer:
            with tr.span("wait", "data_wait"):
                pass
            with tr.span("ckpt", "checkpoint"):
                pass
        tr.record("compute", "compute", outer.start, 1e9, parent=outer)
        spans = {s.name: s for s in tr.spans()}
        by_id = {s.id: s for s in tr.spans()}
        assert spans["wait"].parent_id == spans["step"].id
        assert spans["ckpt"].parent_id == spans["step"].id
        for s in tr.spans():
            if s.parent_id is not None:
                parent = by_id[s.parent_id]
                assert parent.start <= s.start and s.end <= parent.end
        trace = json.loads(json.dumps(tr.to_chrome_trace()))
        events = trace["traceEvents"]
        assert {e["ph"] for e in events} == {"X"}
        for e in events:
            assert e["dur"] >= 0 and "pid" in e and "tid" in e
            assert e["cat"] in ("step", "data_wait", "checkpoint", "compute")
        return trace

    _both(scenario)


def test_tracer_ring_buffer_bounds_memory():
    def scenario(T):
        tr = T.Tracer(capacity=16, clock=_fake_clock())
        for i in range(100):
            with tr.span(f"s{i}", "other"):
                pass
        assert len(tr.spans()) == 16 and tr.dropped == 100 - 16
        assert [s.name for s in tr.spans()][-1] == "s99"
        return tr.to_chrome_trace()

    _both(scenario)


def test_tracer_rejects_unknown_category_and_disabled_mode():
    def scenario(T):
        tr = T.Tracer()
        with pytest.raises(ValueError):
            tr.span("x", "not-a-category")
        off = T.Tracer(enabled=False)
        with off.span("x", "step"):
            pass
        assert off.spans() == []
        assert off.record("y", "compute", 0.0, 1.0) is None
        return sorted(T.CATEGORIES), sorted(T.STEP_CATEGORIES)

    _both(scenario)


def test_tracer_category_totals_use_step_self_time():
    def scenario(T):
        tr = T.Tracer(clock=_fake_clock())
        with tr.span("step", "step"):
            with tr.span("wait", "data_wait"):
                pass
        totals = tr.category_totals()
        assert totals["data_wait"] == 1.0 and totals["step"] == 2.0
        return totals

    _both(scenario)


# ---------------------------------------------------------------------------
# goodput ledger
# ---------------------------------------------------------------------------

def test_goodput_ledger_attributes_and_derives_idle():
    def scenario(T):
        t = {"now": 0.0}
        led = T.GoodputLedger(clock=lambda: t["now"])
        led.start()
        led.add("productive", 6.0)
        led.add("compile", 2.0)
        led.add("data_stall", 1.0)
        t["now"] = 10.0
        snap = led.snapshot()
        assert snap["wall_s"] == 10.0
        assert snap["seconds"]["idle"] == pytest.approx(1.0)
        assert snap["productive_fraction"] == pytest.approx(0.6)
        assert snap["accounted_fraction"] == 1.0
        for bad in ("idle", "nonsense"):
            with pytest.raises(ValueError):
                led.add(bad, 1.0)
        return snap

    _both(scenario)


def test_goodput_recovery_window_and_merge():
    def scenario(T):
        t = {"now": 0.0}
        led = T.GoodputLedger(clock=lambda: t["now"])
        led.start()
        led.add("productive", 2.0)
        t["now"] = 2.0
        led.recovery_begin()
        led.recovery_begin()
        t["now"] = 5.0
        assert led.in_recovery
        assert led.recovery_end() == pytest.approx(3.0)
        assert led.recovery_windows == 1
        t["now"] = 6.0
        snap = led.snapshot()
        assert snap["seconds"]["recovery"] == pytest.approx(3.0)
        assert snap["seconds"]["idle"] == pytest.approx(1.0)
        merged = T.GoodputLedger.merge_snapshots([snap, snap])
        assert merged["hosts"] == 2 and merged["wall_s"] == 12.0
        assert merged["seconds"]["recovery"] == pytest.approx(6.0)
        assert merged["accounted_fraction"] == pytest.approx(1.0)
        return snap, merged

    _both(scenario)


# ---------------------------------------------------------------------------
# Telemetry facade + summaries + run report
# ---------------------------------------------------------------------------

def _pinned(payload):
    """A payload with its two wall-clock stamps fixed and its families'
    help texts left out (the port's work-accounting families describe
    its own counter, not XLA's cost model), so two packages' payloads of
    the same events compare equal."""
    metrics = {name: {k: v for k, v in fam.items() if k != "help"}
               for name, fam in payload["metrics"].items()}
    return dict(payload, ts=1.0, metrics=metrics,
                clock_anchor=dict(payload["clock_anchor"], wall=1.0))


def test_telemetry_facade_hooks_and_summary_export(tmp_path):
    from bigdl_tpu.visualization import TelemetrySummary as JSummary
    from bigdl_tpu.visualization.summary import read_scalars as jread
    from bigdl_tpu_torch.visualization import TelemetrySummary
    from bigdl_tpu_torch.visualization.summary import read_scalars

    def scenario(T):
        clock = _fake_clock(tick=0.01)
        tm = T.Telemetry(registry=T.MetricsRegistry(), host="hostA",
                         tracer=T.Tracer(clock=clock),
                         ledger=T.GoodputLedger(clock=clock),
                         snapshot_dir=str(tmp_path / f"snaps{T is ttel}"))
        tm.on_attempt_begin()
        tm.on_step(0.5, records=32, step=1, compiled=True)
        tm.on_data_wait(0.01, step=2)
        tm.on_step(0.1, records=32, step=2, phase_split=(0.06, 0.03))
        tm.on_checkpoint(0.02, step=2)
        tm.on_checkpoint_blocked(0.005, step=2)
        tm.on_host_to_device(0.001, step=3)
        tm.on_recovery_begin()
        tm.on_step(0.0, records=32, step=3)
        assert tm.steps.value == 3 and tm.records.value == 96
        assert tm.step_seconds.count == 2
        assert tm.compile_seconds.count == 1
        cats = {s.category for s in tm.tracer.spans()}
        assert {"compile", "step", "data_wait", "compute", "collective",
                "checkpoint", "recovery"} <= cats
        summary = (TelemetrySummary if T is ttel else JSummary)(
            str(tmp_path / f"logs{T is ttel}"), "app")
        tm.to_summary(summary, step=3)
        summary.close()
        read = read_scalars if T is ttel else jread
        scalars = {tag: read(summary.log_dir, tag) for tag in (
            "telemetry/steps_total", "telemetry/goodput_fraction",
            "telemetry/accounted_fraction", "telemetry/recovery_windows")}
        assert scalars["telemetry/steps_total"] == [(3, 3.0)]
        path = tm.write_snapshot(step=3)
        payloads = T.read_snapshot_dir(str(tmp_path / f"snaps{T is ttel}"))
        assert path and "hostA" in payloads
        report = T.report.render_report(T.merge_cluster(
            {h: _pinned(p) for h, p in payloads.items()}))
        assert "goodput" in report and "hostA" in report
        return (_pinned(tm.payload(step=3)), tm.tracer.to_chrome_trace(),
                scalars, report)

    _both(scenario)


def test_serving_metrics_quantiles_unchanged_on_fixed_sample():
    from bigdl_tpu.serving import ServingMetrics as JServingMetrics
    from bigdl_tpu.serving import Status as JStatus
    from bigdl_tpu_torch.serving import Status
    from bigdl_tpu_torch.serving.metrics import ServingMetrics

    lats = np.random.RandomState(7).exponential(0.02, size=500).tolist()
    snaps = []
    for metrics, status in ((JServingMetrics, JStatus),
                            (ServingMetrics, Status)):
        m = metrics(window=8192)
        for v in lats:
            m.record(status.OK, latency_s=v, queued_s=v / 4)
        m.record(status.OVERLOADED)
        snap = m.snapshot()
        assert snap["latency_p50_s"] == float(np.percentile(lats, 50))
        assert snap["latency_p99_s"] == float(np.percentile(lats, 99))
        assert snap["served_ok"] == 500 and snap["shed"] == 1
        assert snap["queued_mean_s"] == pytest.approx(
            float(np.mean([v / 4 for v in lats])))
        assert "bigdl_serving_requests_total" in m.to_prometheus()
        snaps.append({k: v for k, v in snap.items()
                      if k not in ("uptime_s", "wall_s")})
    assert snaps[1] == snaps[0]


# ---------------------------------------------------------------------------
# cross-host aggregation over a KV transport
# ---------------------------------------------------------------------------

def test_publish_collect_merge_is_incarnation_keyed():
    def scenario(T):
        kv = KV()
        for host in ("host0", "host1"):
            clock = _fake_clock(tick=0.05)
            tm = T.Telemetry(registry=T.MetricsRegistry(), host=host,
                             tracer=T.Tracer(clock=clock),
                             ledger=T.GoodputLedger(clock=clock))
            tm.on_attempt_begin()
            tm.on_step(0.1, records=4, step=1)
            T.publish_snapshot(kv, host, _pinned(tm.payload(step=1)),
                               incarnation=0)
        assert T.collect_snapshots(kv, incarnation=1) == {}
        got = T.collect_snapshots(kv, incarnation=0)
        assert set(got) == {"host0", "host1"}
        only = T.collect_snapshots(kv, incarnation=0, members=("host0",))
        assert set(only) == {"host0"}
        cluster = T.merge_cluster(got)
        assert cluster["hosts"] == ["host0", "host1"]
        fam = cluster["metrics"]["bigdl_train_steps_total"]
        assert fam["series"][0]["value"] == 2.0
        hist = cluster["metrics"]["bigdl_train_step_seconds"]["series"][0]
        assert hist["count"] == 2 and sum(hist["buckets"]) == 2
        assert cluster["goodput"]["seconds"]["productive"] == \
            pytest.approx(0.2)
        skew = cluster["per_host_skew"]
        assert set(skew) == {"host0", "host1"}
        assert all(abs(rec["skew"] - 1.0) < 1e-6 for rec in skew.values())
        return cluster, T.report.render_report(cluster)

    _both(scenario)


# ---------------------------------------------------------------------------
# driver wiring: LocalOptimizer and DistriOptimizer feed the spine
# ---------------------------------------------------------------------------

def _regression(n=256):
    rng = np.random.RandomState(0)
    x = rng.rand(n, 4).astype(np.float32)
    w = np.array([[1.5], [-2.0], [0.5], [3.0]], np.float32)
    return x, (x @ w + 0.7).astype(np.float32)


def _port_mlp():
    from bigdl_tpu_torch import nn

    g = torch.Generator().manual_seed(0)
    return nn.Sequential(nn.Linear(4, 8, device="cpu", generator=g),
                         nn.Tanh(device="cpu"),
                         nn.Linear(8, 1, device="cpu", generator=g),
                         device="cpu")


def _train_port(tmp, telemetry=None, steps=6):
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import Sample, array
    from bigdl_tpu_torch.optim import (SGD, LocalOptimizer, Trigger,
                                       max_iteration, several_iteration)
    from bigdl_tpu_torch.utils.rng import RNG

    x, y = _regression()
    model = _port_mlp()
    losses = []

    def check(state):
        if "loss" in state:
            losses.append(state["loss"])
        return max_iteration(steps)(state)

    opt = LocalOptimizer(model, array([Sample(a, b) for a, b in zip(x, y)]),
                         nn.MSECriterion(), batch_size=64)
    opt.set_optim_method(SGD(learning_rate=0.2))
    opt.set_end_when(Trigger(check))
    opt.set_checkpoint(str(tmp), several_iteration(3))
    if telemetry is not None:
        opt.set_telemetry(telemetry)
    RNG().set_seed(1)
    opt.optimize()
    return losses, [p.detach().clone() for p in model.parameters()], opt


def _drive_counts(tm):
    names = [s.name for s in tm.tracer.spans()]
    return dict(steps=tm.steps.value, records=tm.records.value,
                compile=tm.compile_seconds.count, step=tm.step_seconds.count,
                checkpoints=tm.checkpoint_seconds.count,
                compile_spans=names.count("compile"),
                step_spans=names.count("step"),
                checkpoint_spans=names.count("checkpoint"),
                span_names=sorted(set(names) - {"data_wait",
                                                "checkpoint_blocked"}))


def test_local_optimizer_feeds_telemetry(tmp_path):
    """Both packages' LocalOptimizer, 6 steps of batch 64 with a
    checkpoint every 3: the same counts, compile and step spans and
    checkpoints (a data wait or a blocked checkpoint is a span only when
    the host clock saw it take time); the port's losses and weights are
    its own run's without telemetry, bit for bit."""
    from bigdl_tpu import nn as jnn
    from bigdl_tpu.dataset import Sample as JSample
    from bigdl_tpu.dataset import array as jarray
    from bigdl_tpu.optim import SGD as JSGD
    from bigdl_tpu.optim import max_iteration as jmax
    from bigdl_tpu.optim import several_iteration as jevery
    from bigdl_tpu.optim.optimizer import LocalOptimizer as JLocal

    x, y = _regression()
    jtm = jtel.Telemetry(registry=jtel.MetricsRegistry(), host="local",
                         snapshot_dir=str(tmp_path / "jsnaps"))
    jopt = JLocal(jnn.Sequential(jnn.Linear(4, 8), jnn.Tanh(),
                                 jnn.Linear(8, 1)),
                  jarray([JSample(a, b) for a, b in zip(x, y)]),
                  jnn.MSECriterion(), batch_size=64)
    jopt.set_optim_method(JSGD(learning_rate=0.2))
    jopt.set_end_when(jmax(6))
    jopt.set_checkpoint(str(tmp_path / "jckpt"), jevery(3))
    jopt.set_telemetry(jtm)
    jopt.optimize()

    tm = ttel.Telemetry(registry=ttel.MetricsRegistry(), host="local",
                        snapshot_dir=str(tmp_path / "snaps"))
    losses, weights, _ = _train_port(tmp_path / "ckpt", tm)
    plain_losses, plain_weights, _ = _train_port(tmp_path / "ckpt2")
    assert losses == plain_losses
    assert all(torch.equal(a, b) for a, b in zip(weights, plain_weights))

    counts = _drive_counts(tm)
    assert counts == _drive_counts(jtm)
    assert counts["steps"] == 6 and counts["records"] == 6 * 64
    assert counts["compile"] == 1 and counts["step"] == 5
    assert counts["checkpoints"] == 2
    gp = tm.ledger.snapshot()
    assert gp["seconds"]["productive"] > 0 and gp["seconds"]["compile"] > 0
    assert gp["accounted_fraction"] >= 0.99
    trace = json.loads(json.dumps(tm.tracer.to_chrome_trace()))
    names = [e["name"] for e in trace["traceEvents"]]
    assert names.count("step") == 5 and "checkpoint" in names
    assert "local" in ttel.read_snapshot_dir(str(tmp_path / "snaps"))


def _launch_ranks(world, workdir, names):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    init = f"file://{workdir / 'store'}"
    return [subprocess.Popen(
        [sys.executable, str(Path(child.__file__)), str(r), str(world), init,
         str(workdir), names], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, env=env, cwd=str(REPO))
        for r in range(world)]


@pytest.fixture(scope="module")
def distri2(tmp_path_factory):
    """The child's ``telemetry`` scenario at 2 gloo ranks: the ranks'
    results in rank order."""
    workdir = tmp_path_factory.mktemp("telemetry2")
    (workdir / "inputs.pkl").write_bytes(pickle.dumps({}))
    procs = _launch_ranks(2, workdir, "telemetry")
    deadline = time.monotonic() + LAUNCH_TIMEOUT_S
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            outs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        pytest.fail(f"a rank hung past {LAUNCH_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, out in enumerate(outs):
        path = workdir / f"rank{r}.pkl"
        assert path.exists(), out[-3000:]
        got = pickle.loads(path.read_bytes())
        assert "error" not in got, got.get("error")
        results.append(got["telemetry"])
    return results


def test_distri_optimizer_feeds_telemetry_on_every_rank(distri2):
    """12 steps of batch 64 over 2 gloo ranks: every rank counts 12
    steps of 32 records, one compile; the default profile interval
    profiles iteration 10, whose step span gets compute and collective
    children (a gloo all-reduce takes host time: collective_s > 0); the
    wire estimate is the JAX plan's ``collective_bytes`` of the same
    model on a data mesh of 2 (2·(1/2) times the parameters' own bytes,
    no loss); losses and weights equal the run without telemetry bit for
    bit."""
    for rank, got in enumerate(distri2):
        tm, plain = got["telemetry"], got["plain"]
        assert (tm["steps"], tm["records"]) == (12, 12 * 32), rank
        assert (tm["compile_count"], tm["step_count"]) == (1, 11)
        assert tm["phase_source"] == "trace"
        compute, collective = tm["children"]["compute"], \
            tm["children"]["collective"]
        assert compute[0] == collective[0] == 10
        assert compute[1] > 0 and collective[1] > 0
        prog = tm["payload"]["perf"]["programs"]["train_step"]
        assert prog["collective_bytes"] == _jax_collective_bytes(2)
        assert prog["flops"] > 0
        assert {"host_to_device", "compute", "collective"} <= set(
            tm["span_names"])
        assert tm["accounted"] >= 0.99
        assert tm["losses"] == plain["losses"]
        for name in plain["params"]:
            for key, v in plain["params"][name].items():
                assert np.array_equal(tm["params"][name][key], v)
    assert distri2[0]["telemetry"]["losses"] == \
        distri2[1]["telemetry"]["losses"]


def _jax_collective_bytes(world):
    """The JAX engine's figure for the child's regression MLP on a
    ``("data",)`` mesh of ``world`` devices (``plan.py:1730``)."""
    import jax
    from jax.sharding import Mesh

    from bigdl_tpu import nn as jnn
    from bigdl_tpu.parallel.plan import derive_plan

    jm = jnn.Sequential(jnn.Linear(4, 8), jnn.Tanh(), jnn.Linear(8, 1))
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
    return derive_plan(jm, mesh).collective_bytes(jm.param_tree())


def test_distri_optimizer_counts_like_jax_distri():
    """One process: the JAX DistriOptimizer on the 8 virtual devices
    and the port's on a group of one count the same steps, compile and
    profiled children (iteration 10 of 12), the port's wire estimate 0
    at one rank."""
    from bigdl_tpu import nn as jnn
    from bigdl_tpu.dataset import Sample as JSample
    from bigdl_tpu.dataset import array as jarray
    from bigdl_tpu.optim import SGD as JSGD
    from bigdl_tpu.optim import max_iteration as jmax
    from bigdl_tpu.optim.distri_optimizer import DistriOptimizer as JDistri
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import Sample, array
    from bigdl_tpu_torch.optim import SGD, DistriOptimizer, max_iteration
    from bigdl_tpu_torch.utils.engine import Engine

    x, y = _regression()
    jtm = jtel.Telemetry(registry=jtel.MetricsRegistry(), host="d0")
    jopt = JDistri(jnn.Sequential(jnn.Linear(4, 8), jnn.Tanh(),
                                  jnn.Linear(8, 1)),
                   jarray([JSample(a, b) for a, b in zip(x, y)]),
                   jnn.MSECriterion(), batch_size=64)
    jopt.set_optim_method(JSGD(learning_rate=0.2))
    jopt.set_end_when(jmax(12))
    jopt.set_telemetry(jtm)
    jopt.optimize()

    Engine.reset()
    try:
        tm = ttel.Telemetry(registry=ttel.MetricsRegistry(), host="d0")
        opt = DistriOptimizer(_port_mlp(),
                              array([Sample(a, b) for a, b in zip(x, y)]),
                              nn.MSECriterion(), batch_size=64)
        opt.set_optim_method(SGD(learning_rate=0.2))
        opt.set_end_when(max_iteration(12))
        opt.set_telemetry(tm)
        opt.optimize()
    finally:
        Engine.reset()
    for t in (tm, jtm):
        assert t.steps.value == 12 and t.compile_seconds.count == 1
        assert t.ledger.snapshot()["accounted_fraction"] >= 0.99
    assert opt.phase_source == jopt.phase_source == "trace"
    cats = {s.category for s in tm.tracer.spans()}
    assert "compute" in cats and cats == {
        s.category for s in jtm.tracer.spans()} | {"host_to_device"}
    assert tm.payload()["perf"]["programs"]["train_step"][
        "collective_bytes"] == 0.0


# ---------------------------------------------------------------------------
# profiling: the typed PhaseSplit and the torch.profiler split
# ---------------------------------------------------------------------------

def test_phase_split_is_typed_and_unpacks():
    from bigdl_tpu.optim.profiling import PhaseSplit as JPhaseSplit
    from bigdl_tpu_torch.optim.profiling import PhaseSplit

    for cls in (JPhaseSplit, PhaseSplit):
        split = cls(0.06, 0.02)
        c, a = split
        assert (c, a) == (0.06, 0.02)
        assert split.compute_s == 0.06 and split.collective_s == 0.02
        assert split.total_s == pytest.approx(0.08)
        assert split.compute_fraction == pytest.approx(0.75)


def test_trace_phase_split_runs_once_and_reads_host_time():
    """On the CPU the split is host op time: a matmul loop is compute,
    no collective; ``run`` runs exactly once and its error propagates."""
    from bigdl_tpu_torch.optim.profiling import trace_phase_split

    calls = []
    x = torch.randn(64, 64)

    def run():
        calls.append(1)
        for _ in range(20):
            x @ x

    split = trace_phase_split(run, "cpu")
    assert calls == [1]
    assert split.compute_s > 0 and split.collective_s == 0.0

    def boom():
        raise RuntimeError("step failed")

    with pytest.raises(RuntimeError, match="step failed"):
        trace_phase_split(boom, "cpu")
    assert trace_phase_split(lambda: None, "cpu") is None


# ---------------------------------------------------------------------------
# resilience counters land in the process-wide default registry
# ---------------------------------------------------------------------------

def test_retry_counts_into_default_registry():
    from bigdl_tpu_torch.resilience import RetryPolicy

    r = ttel.default_registry()

    def val(name):
        fam = r.get(name)
        return fam.value if fam is not None else 0.0

    retries0 = val("bigdl_retry_attempts_total")
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return "ok"

    policy = RetryPolicy(max_retries=5, backoff_base=0.0, jitter=0.0)
    assert policy.run(flaky) == "ok"
    assert val("bigdl_retry_attempts_total") == retries0 + 2


# ---------------------------------------------------------------------------
# lint: every bigdl_* metric family name literal is in the shared table
# ---------------------------------------------------------------------------

_METRIC_LITERAL = re.compile(r"""["'](bigdl_[a-z0-9]+(?:_[a-z0-9]+)+)["']""")


def test_metric_family_names_come_from_shared_table():
    """Every ``"bigdl_*"`` family-shaped literal in ``bigdl_tpu_torch/``
    is a member of the port's ``METRIC_FAMILY_NAMES``, which is the
    JAX package's table.  ``ops/`` is left out: its literals of that
    shape are the CUDA libraries' C entry points (``bigdl_flash_fwd``),
    no metric."""
    from bigdl_tpu.telemetry.metric_names import (
        METRIC_FAMILY_NAMES as JNAMES)
    from bigdl_tpu_torch.telemetry.metric_names import METRIC_FAMILY_NAMES

    assert METRIC_FAMILY_NAMES == JNAMES and len(METRIC_FAMILY_NAMES) > 40
    pkg = REPO / "bigdl_tpu_torch"
    offenders = []
    for path in sorted(pkg.rglob("*.py")):
        rel = path.relative_to(pkg)
        if rel.parts[0] == "ops":
            continue
        for lineno, line in enumerate(path.read_text().splitlines(), 1):
            code = line.split("#", 1)[0]
            offenders += [f"{rel}:{lineno}: {name}"
                          for name in _METRIC_LITERAL.findall(code)
                          if name not in METRIC_FAMILY_NAMES
                          and name != "bigdl_tpu_torch"]
    assert not offenders, "\n".join(offenders)


# ---------------------------------------------------------------------------
# exemplars survive the cross-host merge
# ---------------------------------------------------------------------------

def test_exemplars_survive_cross_host_merge_roundtrip():
    def scenario(T):
        def host(trace_low, trace_high, ts):
            r = T.MetricsRegistry()
            h = r.histogram("bigdl_serving_latency_seconds", "lat",
                            bounds=(0.1, 1.0))
            h.observe(0.05, exemplar=trace_low)
            h.observe(0.5, exemplar=trace_high)
            snap = r.snapshot()["metrics"]
            for series in snap["bigdl_serving_latency_seconds"]["series"]:
                for ex in series["exemplars"].values():
                    ex["ts"] = ts
            return snap

        older, newer = host("aaaa", "bbbb", 100.0), host("cccc", "dddd", 200.0)
        merged = T.aggregate.merge_metrics([older, newer])
        series = merged["bigdl_serving_latency_seconds"]["series"][0]
        assert series["count"] == 4
        ex = series["exemplars"]
        assert ex["0"]["trace_id"] == "cccc" and ex["1"]["trace_id"] == "dddd"
        merged2 = T.aggregate.merge_metrics([newer, older])
        assert merged2["bigdl_serving_latency_seconds"]["series"][0][
            "exemplars"] == ex
        text = T.aggregate.metrics_to_prometheus(merged)
        assert '# {trace_id="cccc"} 0.05' in text
        assert '# {trace_id="dddd"} 0.5' in text
        counts = [int(ln.split(" # ")[0].rsplit(" ", 1)[1])
                  for ln in text.splitlines()
                  if ln.startswith("bigdl_serving_latency_seconds_bucket")]
        assert counts == [2, 4, 4]
        return merged, text

    _both(scenario)


def test_exemplar_merge_drops_on_geometry_drift():
    def scenario(T):
        def host(bounds):
            r = T.MetricsRegistry()
            h = r.histogram("bigdl_serving_latency_seconds", "lat",
                            bounds=bounds)
            h.observe(0.05, exemplar="eeee")
            snap = r.snapshot()["metrics"]
            for series in snap["bigdl_serving_latency_seconds"]["series"]:
                for ex in series["exemplars"].values():
                    ex["ts"] = 1.0
            return snap

        merged = T.aggregate.merge_metrics([host((0.1, 1.0)),
                                            host((0.2, 2.0))])
        series = merged["bigdl_serving_latency_seconds"]["series"][0]
        assert "buckets" not in series and "exemplars" not in series
        assert series["count"] == 2
        return merged

    _both(scenario)


def test_histogram_module_exports_match():
    assert Histogram is ttel.Histogram
    assert default_buckets(1e-3, 2.0, 4) == jtel.default_buckets(1e-3, 2.0, 4)
