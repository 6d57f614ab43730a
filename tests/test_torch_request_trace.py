"""The port's request tracing (``bigdl_tpu_torch/serving/request_trace.py``
and the trace points of its ``InferenceServer``) against the JAX
package's, on the CPU.

Every spec of ``tests/test_request_trace.py`` is mirrored: the same
contexts, the same request stream from a numpy seed, the same fault
schedule and the same weights go through the JAX fleet and the port's;
each scenario makes the reference's assertions on both, and the two
sides' readings — typed statuses, kept-trace counts and reasons, the
stitched categories and hosts, attempt labels, greedy tokens, classify
outputs within 1e-4 (rtol 0, ``tests/test_torch_serving.py``'s
tolerance) — must be equal.  Coverage and attribution are wall-clock
readings: each side is held to the reference's limits, not to the
other's number.  Each spec that starts a fleet or server stops it in
``finally`` under a deadline of its own.
"""
import time

import numpy as np
import pytest
import torch

from _torch_fleet_sides import (JAX, PORT, SpecDeadline, both, outputs,
                                statuses)

torch.set_num_threads(1)

VOCAB, TMAX = 23, 32
DEADLINE_S = 120
LM_KW = dict(embed_dim=16, num_heads=2, mlp_dim=32, num_layers=1,
             max_len=TMAX)


def make_fleet(side, n=2, hedge=False, hedge_delay_s=0.05,
               keep_per_s=1e6, deadline_s=10.0, **router_kw):
    """A traced fleet whose membership does not change: no pump thread,
    the beats of ``start()`` fresh for the spec deadline's length (the
    kill spec builds its own, pumped)."""
    fl = side.serving.ServingFleet.build(
        side.small_model(), n_replicas=n,
        server_kw=dict(max_batch=8, max_queue=64),
        heartbeat_timeout=DEADLINE_S, pump_interval_s=0,
        tracing=True, trace_kw=dict(keep_per_s=keep_per_s,
                                    burst=keep_per_s),
        router_kw=dict(default_deadline_s=deadline_s, hedge=hedge,
                       hedge_delay_s=hedge_delay_s, **router_kw))
    return fl


def feat(rng):
    return rng.rand(4).astype(np.float32)


def attempt_spans(trace, kind=None):
    out = [e for e in trace["traceEvents"]
           if e.get("ph") == "X" and e.get("cat") == "attempt"]
    if kind is not None:
        out = [e for e in out if e["args"].get("kind") == kind]
    return out


def cats_of(trace):
    return sorted({e["cat"] for e in trace["traceEvents"]
                   if e.get("ph") == "X"})


# ---------------------------------------------------------------------------
# context + sampler units
# ---------------------------------------------------------------------------

def test_trace_context_wire_roundtrip_and_malformed_degrades():
    def scenario(side):
        TraceContext = side.trace_context.TraceContext
        ctx = TraceContext.mint(deadline_s=2.5)
        child = ctx.child(7, remaining_s=1.25, attempt=2, phase="decode")
        wire = child.to_wire()
        back = TraceContext.from_wire(wire)
        assert back == child
        assert TraceContext.mint().trace_id != ctx.trace_id
        assert TraceContext.from_wire({"nope": 1}) is None
        assert TraceContext.from_wire("garbage") is None
        assert TraceContext.from_wire(None) is None
        return sorted(wire)
    both(scenario)
    # a context minted by one package reads in the other
    ctx = JAX.trace_context.TraceContext.mint(deadline_s=1.0)
    assert PORT.trace_context.TraceContext.from_wire(
        ctx.to_wire()).to_wire() == ctx.to_wire()


def test_tail_sampler_always_keeps_trouble_budgets_ok():
    def scenario(side):
        t = [0.0]
        s = side.trace_context.TailSampler(keep_per_s=1.0, burst=2.0,
                                           clock=lambda: t[0])
        for _ in range(50):
            assert s.keep(ok=False) == "error"
            assert s.keep(ok=True, retried=True) == "retry"
            assert s.keep(ok=True, hedged=True) == "hedge"
            assert s.keep(ok=True, latency_s=0.9, p99_s=0.5) == "p99"
        kept = sum(s.keep(ok=True, latency_s=0.01, p99_s=1.0) is not None
                   for _ in range(50))
        assert kept == 2
        t[0] = 3.0
        kept2 = sum(s.keep(ok=True, latency_s=0.01, p99_s=1.0)
                    is not None for _ in range(50))
        assert kept2 == 2
        snap = s.snapshot()
        assert snap["kept"]["error"] == 50 and snap["dropped"] > 0
        return snap
    both(scenario)


# ---------------------------------------------------------------------------
# classify path: stitching, coverage, exemplars
# ---------------------------------------------------------------------------

def test_traced_classify_stitches_with_coverage_and_exemplars():
    def scenario(side):
        with SpecDeadline(DEADLINE_S) as dl:
            fl = dl.add(make_fleet(side, n=2)).start()
            rng = np.random.RandomState(0)
            try:
                res = [fl.submit(feat(rng)).result(60) for _ in range(6)]
                assert all(r.ok for r in res)
                assert all(r.trace_id for r in res)
                kept = fl.kept_traces()
                assert len(kept) == 6
                t = fl.stitch_trace(res[-1].trace_id)
                cats = set(cats_of(t))
                assert {"request", "attempt", "queue", "batch",
                        "execute"} <= cats
                assert cats <= set(side.trace_context.REQUEST_CATEGORIES)
                assert len(t["hosts"]) >= 2
                cov = side.serving.trace_coverage(t)
                assert cov is not None and cov >= 0.95
                attr = side.serving.trace_attribution(t)
                assert attr["critical_phase"] in (
                    "compute", "queue", "batch", "kv", "transport")
                text = fl.router.metrics.to_prometheus()
                assert 'trace_id="' in text
                return {"statuses": statuses(res),
                        "outputs": outputs(res), "kept": len(kept),
                        "cats": sorted(cats),
                        "n_hosts": len(t["hosts"])}
            finally:
                fl.stop(timeout=15)
    both(scenario)


def test_retry_forks_context_with_remaining_budget_per_attempt():
    def scenario(side):
        with SpecDeadline(DEADLINE_S) as dl:
            fl = dl.add(make_fleet(side, n=2)).start()
            rng = np.random.RandomState(1)
            try:
                [fl.submit(feat(rng)).result(60) for _ in range(4)]
                with side.faults.serving_step_failures(
                        times=1, server="r0") as b:
                    res = [fl.submit(feat(rng),
                                     deadline_s=10.0).result(60)
                           for _ in range(6)]
                    assert b["fired"] == 1
                assert all(r.ok for r in res)
                retried = [k for k in fl.kept_traces() if k["retried"]]
                assert retried
                t = fl.stitch_trace(retried[0]["trace_id"])
                atts = sorted(attempt_spans(t),
                              key=lambda e: e["args"]["attempt"])
                assert len(atts) == 2
                assert atts[0]["args"]["replica"] \
                    != atts[1]["args"]["replica"]
                b0 = atts[0]["args"]["remaining_budget_s"]
                b1 = atts[1]["args"]["remaining_budget_s"]
                assert b0 is not None and b1 is not None \
                    and b1 < b0 <= 10.0
                assert atts[0]["args"]["status"] == "internal_error"
                assert atts[1]["args"]["status"] == "ok"
                return {"statuses": statuses(res),
                        "outputs": outputs(res),
                        "retried": len(retried),
                        "attempts": [(a["args"]["replica"],
                                      a["args"]["status"])
                                     for a in atts]}
            finally:
                fl.stop(timeout=15)
    both(scenario)


def test_hedge_loser_closes_as_lost_at_discard_no_double_count():
    def scenario(side):
        with SpecDeadline(DEADLINE_S) as dl:
            fl = dl.add(make_fleet(side, n=2, hedge=True,
                                   hedge_delay_s=0.05)).start()
            rng = np.random.RandomState(2)
            try:
                [fl.submit(feat(rng)).result(60) for _ in range(4)]
                time.sleep(0.1)
                hedged0 = {k["trace_id"] for k in fl.kept_traces()
                           if k["hedged"]}
                with side.faults.delay_replica("r0", 0.4, times=4):
                    r = fl.submit(feat(rng), deadline_s=10.0).result(30)
                assert r.ok
                hedged = [k for k in fl.kept_traces()
                          if k["hedged"] and k["trace_id"] not in hedged0]
                assert hedged
                time.sleep(0.6)
                t = fl.stitch_trace(hedged[0]["trace_id"])
                outcomes = sorted(
                    e["args"].get("hedge_outcome")
                    for e in attempt_spans(t)
                    if e["args"].get("hedge_outcome") is not None)
                assert outcomes == ["lost", "won"]
                cov = side.serving.trace_coverage(t)
                assert cov is not None and 0.95 <= cov <= 1.0
                attr = side.serving.trace_attribution(t)
                assert attr["phases"].get("compute", 0.0) \
                    <= attr["wall_s"] + 1e-6
                lost_exec = [
                    e for e in t["traceEvents"] if e.get("ph") == "X"
                    and e.get("cat") in ("queue", "execute")
                    and (e["args"] or {}).get("hedge_outcome") == "lost"]
                assert lost_exec
                return {"output": r.output, "outcomes": outcomes,
                        "hedged": len(hedged)}
            finally:
                fl.stop(timeout=15)
    both(scenario)


# ---------------------------------------------------------------------------
# handoff propagation + typed error span
# ---------------------------------------------------------------------------

def test_context_survives_handoff_blob_bit_for_bit():
    def scenario(side):
        pools = side.pools
        tc = side.trace_context
        ctx = tc.TraceContext.mint(deadline_s=3.0).child(
            9, remaining_s=1.5, attempt=1, phase="decode")
        k = np.zeros((2, 1, 2, 4, 8), np.float32)
        blob = pools.serialize_handoff(
            k, k, first_token=5, pos=3, page_size=4,
            extras={tc.TRACE_WIRE_KEY: ctx.to_wire()})
        wire = pools.deserialize_handoff(blob)[tc.TRACE_WIRE_KEY]
        assert wire == ctx.to_wire()
        assert tc.TraceContext.from_wire(wire) == ctx
        assert pools.peek_handoff_trace(blob) == ctx.to_wire()
        bad = bytearray(blob)
        bad[-1] ^= 0xFF
        assert pools.peek_handoff_trace(bytes(bad)) is None
        return blob
    got = {side.name: scenario(side) for side in (JAX, PORT)}
    # the two packages seal the same context into the same bytes
    # except the trace ids each minted; a blob sealed by one peeks the
    # same context in the other
    jax_blob = got["jax"]
    assert PORT.pools.peek_handoff_trace(jax_blob) \
        == JAX.pools.peek_handoff_trace(jax_blob)
    assert JAX.pools.peek_handoff_trace(got["port"]) \
        == PORT.pools.peek_handoff_trace(got["port"])


def test_corrupt_handoff_yields_typed_error_span():
    def scenario(side):
        model = side.lm(VOCAB, **LM_KW)
        kv = side.elastic.InMemoryKV()
        sink = side.request_trace.ReplicaTraceSink("rX", transport=kv)
        srv = side.serving.InferenceServer(
            model, name="rX", max_batch=4,
            kv_pool=side.kvpool.KVPagePool.for_model(model, 32,
                                                     page_size=4),
            trace_sink=sink).start()
        try:
            ctx = side.trace_context.TraceContext.mint(deadline_s=10.0)
            res = srv.submit_decode(b"BKVHgarbage", max_new=4,
                                    trace=ctx.to_wire()).result(60)
            assert res.status.value == "internal_error"
            assert "Handoff" in res.error or "handoff" in res.error
            assert res.trace_id == ctx.trace_id
            frag = sink.fragment(ctx.trace_id)
            errs = [s for s in frag["spans"] if s["cat"] == "error"]
            assert errs and errs[0]["args"]["status"] == "internal_error"
            sink.flush()
            assert any(k.startswith("trc/") and ctx.trace_id in k
                       for k in kv.keys("trc/"))
            return {"status": res.status.value,
                    "span_cats": sorted(s["cat"] for s in frag["spans"]),
                    "error_status": errs[0]["args"]["status"]}
        finally:
            srv.stop(timeout=15)
    both(scenario)


def test_traced_paged_generate_records_prefill_and_decode_spans():
    """The paged path's trace points: a traced generate on a server
    with a KV pool records queue, prefill and decode spans, each ended
    after the tokens were on the host (the decode span covers every
    step), and the tokens equal the untraced stream's."""
    def scenario(side):
        model = side.lm(VOCAB, **LM_KW)
        kv = side.elastic.InMemoryKV()
        sink = side.request_trace.ReplicaTraceSink("rP", transport=kv)
        srv = side.serving.InferenceServer(
            model, name="rP", max_batch=4,
            kv_pool=side.kvpool.KVPagePool.for_model(model, 32,
                                                     page_size=4),
            trace_sink=sink).start()
        rng = np.random.RandomState(5)
        prompt = rng.randint(1, VOCAB + 1, (6,)).astype(np.int32)
        try:
            ctx = side.trace_context.TraceContext.mint(deadline_s=30.0)
            traced = srv.submit_generate(prompt, 5,
                                         trace=ctx.to_wire()).result(60)
            plain = srv.submit_generate(prompt, 5).result(60)
            assert traced.ok and plain.ok
            np.testing.assert_array_equal(traced.output, plain.output)
            frag = sink.fragment(ctx.trace_id)
            spans = {s["name"]: s for s in frag["spans"]}
            assert {"admission_queue", "prefill", "decode"} <= set(spans)
            assert spans["decode"]["args"]["steps"] == 4
            assert spans["decode"]["args"]["tokens"] == 5
            return {"tokens": traced.output,
                    "names": sorted(spans),
                    "decode_args": {k: spans["decode"]["args"][k]
                                    for k in ("steps", "tokens")}}
        finally:
            srv.stop(timeout=15)
    both(scenario)


# ---------------------------------------------------------------------------
# kill mid-decode: the failed attempt AND the replay stitch into one
# ---------------------------------------------------------------------------

def test_kill_mid_decode_stitches_failed_and_replayed_attempts():
    def scenario(side):
        model = side.lm(VOCAB, **LM_KW)
        with SpecDeadline(DEADLINE_S) as dl:
            fl = dl.add(side.serving.ServingFleet.build(
                model, n_replicas=3, roles=("prefill", "decode", "decode"),
                kv_pages=32, kv_page_size=4, server_kw=dict(max_batch=8),
                heartbeat_timeout=0.4, pump_interval_s=0.05,
                tracing=True, trace_kw=dict(keep_per_s=1e6, burst=1e6),
                router_kw=dict(default_deadline_s=60.0,
                               disaggregate=True)))
            fl.start()
            rng = np.random.RandomState(3)
            prompt = rng.randint(1, VOCAB + 1, (5,)).astype(np.int32)
            try:
                warm = fl.submit_generate(prompt, max_new=3).result(300)
                assert warm.ok
                killed = None
                with side.faults.serving_step_latency(0.05,
                                                      times=1 << 10):
                    fut = fl.submit_generate(prompt, max_new=16)
                    deadline = time.monotonic() + 10
                    while killed is None and time.monotonic() < deadline:
                        snap = fl.router.snapshot()
                        for rid in ("r1", "r2"):
                            if snap["inflight"].get(rid, 0) > 0:
                                killed = rid
                                break
                        time.sleep(0.02)
                    assert killed is not None
                    with side.faults.kill_replica(killed):
                        k_deadline = time.monotonic() + 15
                        while fl.servers[killed].healthy() \
                                and time.monotonic() < k_deadline:
                            time.sleep(0.02)
                    res = fut.result(300)
                assert res.ok, (res.status, res.error)
                t = fl.stitch_trace(res.trace_id)
                assert t is not None
                dec = attempt_spans(t, kind="decode")
                sts = {e["args"].get("status") for e in dec}
                replicas = {e["args"].get("replica") for e in dec}
                assert len(dec) >= 2
                assert len(replicas) >= 2 and killed in replicas
                assert "ok" in sts
                assert any(s not in ("ok", None) for s in sts)
                budgets = [e["args"]["remaining_budget_s"]
                           for e in sorted(
                               dec, key=lambda e: e["args"]["attempt"])]
                assert all(b is not None for b in budgets)
                assert budgets[-1] < budgets[0]
                # the handoff crossed the pools: a prefill fragment and
                # the decode fragments stitch into one trace
                assert "r0" in t["hosts"] and killed in t["hosts"]
                return {"warm": warm.output, "tokens": res.output,
                        "status": res.status.value,
                        "replayed": len(replicas) >= 2}
            finally:
                fl.stop(timeout=15)
    both(scenario)


# ---------------------------------------------------------------------------
# tail sampling on the fleet: trouble always kept, OK bounded
# ---------------------------------------------------------------------------

def test_fleet_tail_sampling_keeps_all_errors_bounds_ok_traffic():
    def scenario(side):
        with SpecDeadline(DEADLINE_S) as dl:
            fl = dl.add(make_fleet(side, n=2, keep_per_s=0.0001,
                                   deadline_s=2.0, max_attempts=1))
            fl.start()
            rng = np.random.RandomState(4)
            try:
                warm = fl.submit(feat(rng)).result(60)
                assert warm.ok
                with side.faults.serving_step_failures(times=8):
                    errs = [fl.submit(feat(rng)).result(60)
                            for _ in range(3)]
                assert all(r.status.value == "internal_error"
                           for r in errs)
                oks = [fl.submit(feat(rng)).result(60)
                       for _ in range(20)]
                assert all(r.ok for r in oks)
                kept = fl.kept_traces()
                kept_ids = {k["trace_id"] for k in kept}
                assert all(r.trace_id in kept_ids for r in errs)
                ok_kept = [k for k in kept if k["status"] == "ok"
                           and k["reason"] == "budget"]
                assert len(ok_kept) <= 2
                snap = fl.tracing.sampler.snapshot()
                assert snap["dropped"] >= 18
                return {"statuses": statuses([warm] + errs + oks),
                        "outputs": outputs([warm] + oks),
                        "errors_kept": sum(r.trace_id in kept_ids
                                           for r in errs)}
            finally:
                fl.stop(timeout=15)
    both(scenario)


# ---------------------------------------------------------------------------
# exemplar mechanics on the registry histogram
# ---------------------------------------------------------------------------

def test_histogram_exemplars_snapshot_and_prometheus():
    def scenario(side):
        tel = side.telemetry
        h = tel.Histogram(bounds=(0.1, 1.0))
        h.observe(0.05, exemplar="aaaa")
        h.observe(0.5)
        h.observe(0.05, exemplar="bbbb")
        ex = h.exemplars()
        assert set(ex) == {0}
        assert ex[0]["value"] == 0.05 and ex[0]["trace_id"] == "bbbb"
        assert ex[0]["ts"] > 0
        assert h._data()["exemplars"]["0"]["trace_id"] == "bbbb"
        r = tel.MetricsRegistry()
        fam = r.histogram("lat_seconds", "t", bounds=(0.1, 1.0))
        fam.observe(0.05, exemplar="cccc")
        text = r.to_prometheus()
        assert '# {trace_id="cccc"} 0.05' in text
        snap = r.snapshot()["metrics"]
        merged = tel.merge_metrics([snap, snap])
        series = merged["lat_seconds"]["series"][0]
        assert series["exemplars"]["0"]["trace_id"] == "cccc"
        return [line for line in text.splitlines() if "cccc" in line]
    both(scenario)
