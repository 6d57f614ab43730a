"""The port's multi-tenant fleet (``bigdl_tpu_torch/serving/registry.py``
and the tenant-aware routing, admission, KV accounting, deploys, SLO
packs and autoscaler pools around it) against the JAX package's, on the
CPU.

Every spec of ``tests/test_multitenant.py`` is mirrored: the same two
models (weights drawn by the JAX package, carried into the port), the
same request stream from a numpy seed and the same fault schedule go
through the JAX fleet and the port's; each scenario makes the
reference's assertions on both, and the two sides' readings — typed
statuses (``NOT_FOUND``, ``OVERLOADED`` with ``tenant_quota``), shed,
admission, dispatch and deploy counts, advertised versions and classify
outputs within 1e-4 (rtol 0, ``tests/test_torch_serving.py``'s
tolerance) — must be equal.  The chaos spec's tenant-B p99 ratio is
replaced by counts: tenant B sheds nothing and every one of its requests
is OK, while the flooded tenant A sheds.  Each spec that starts a fleet
stops it in ``finally`` under a deadline of its own.
"""
import json
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch

from _torch_fleet_sides import (PORT, SpecDeadline, both, outputs,
                                statuses)

torch.set_num_threads(1)

DEADLINE_S = 90


def feat(rng):
    return rng.rand(4).astype(np.float32)


def multi_fleet(side, n=2, quotas=None, capacity=None,
                pump_interval_s=0.05, heartbeat_timeout=0.4,
                default_deadline_s=10.0, max_queue=64,
                deadline_budgets=None, **fleet_kw):
    return side.serving.ServingFleet.build_multi(
        {"alpha": side.small_model(seed=0),
         "beta": side.small_model(seed=1)},
        n_replicas_each=n,
        server_kw=dict(max_batch=8, max_queue=max_queue),
        quotas=quotas, admission_capacity=capacity,
        deadline_budgets=deadline_budgets,
        heartbeat_timeout=heartbeat_timeout,
        pump_interval_s=pump_interval_s,
        router_kw=dict(default_deadline_s=default_deadline_s),
        **fleet_kw)


def with_multi(body, **kw):
    def scenario(side):
        with SpecDeadline(DEADLINE_S) as dl:
            fl = dl.add(multi_fleet(side, pump_interval_s=0, **kw))
            fl.start()
            try:
                return body(side, fl)
            finally:
                fl.stop(timeout=10)
    return scenario


# ---------------------------------------------------------------------------
# ModelRegistry
# ---------------------------------------------------------------------------

def test_registry_lifecycle_and_advertisers():
    def scenario(side):
        ModelRegistry = side.registry.ModelRegistry
        reg = ModelRegistry()
        assert reg.register("alpha") == "v1"
        assert reg.register("beta", "b7") == "b7"
        assert reg.lookup("alpha") == "v1"
        assert reg.has("beta") and not reg.has("ghost")
        assert reg.lookup("ghost") is None
        assert reg.register("alpha", "v2") == "v2"
        assert reg.models() == {"alpha": "v2", "beta": "b7"}
        assert reg.unregister("beta") is True
        assert reg.unregister("beta") is False
        assert reg.lookup("beta") is None
        health = {"r0": {"model": "alpha"}, "r1": {"model": "beta"},
                  "r2": {"model": "alpha"}, "r3": {}}
        assert ModelRegistry.advertisers("alpha", health) == ["r0", "r2"]
        assert ModelRegistry.advertisers("ghost", health) == []
        return reg.models()
    both(scenario)


def test_unregister_model_mid_flight_injector():
    def scenario(side):
        reg = side.registry.ModelRegistry()
        reg.register("alpha")
        with side.faults.unregister_model_mid_flight("alpha") as f:
            assert reg.lookup("alpha") is None
        assert not reg.has("alpha")
        reg.register("alpha")
        assert reg.lookup("alpha") == "v1"
        return f["fired"]
    both(scenario)


# ---------------------------------------------------------------------------
# AdmissionController: weighted quotas, fair shed ordering, deadlines
# ---------------------------------------------------------------------------

def test_weighted_shed_ordering_quota_before_global():
    def scenario(side):
        ac = side.registry.AdmissionController(
            capacity=6, quotas={"a": 2.0, "b": 1.0})
        assert ac.budget("a") == 4 and ac.budget("b") == 2
        seq = []
        for _ in range(4):
            seq.append(ac.try_admit("a"))
            assert seq[-1] == (True, ac.ADMITTED)
        seq.append(ac.try_admit("a"))
        assert seq[-1] == (False, ac.TENANT_QUOTA)
        for _ in range(2):
            seq.append(ac.try_admit("b"))
            assert seq[-1] == (True, ac.ADMITTED)
        seq.append(ac.try_admit("b"))
        assert seq[-1] == (False, ac.TENANT_QUOTA)
        assert ac.budget("c") == 1
        seq.append(ac.try_admit("c"))
        assert seq[-1] == (False, ac.GLOBAL)
        ac.release("a")
        seq.append(ac.try_admit("c"))
        assert seq[-1] == (True, ac.ADMITTED)
        snap = ac.snapshot()
        assert snap["total_inflight"] == 6 == snap["capacity"]
        assert snap["inflight"] == {"a": 3, "b": 2, "c": 1}
        return {"seq": seq, "snap": snap}
    both(scenario)


def test_tenant_deadline_budget_clamps():
    def scenario(side):
        ac = side.registry.AdmissionController(
            capacity=4, deadline_budgets={"a": 0.5})
        got = [ac.deadline_for("a", 2.0), ac.deadline_for("a", 0.2),
               ac.deadline_for("a", None), ac.deadline_for("b", 2.0),
               ac.deadline_for("b", None)]
        assert got == [0.5, 0.2, 0.5, 2.0, None]
        return got
    both(scenario)


# ---------------------------------------------------------------------------
# tenant-scoped KV-page accounting
# ---------------------------------------------------------------------------

def test_kv_owner_budget_isolates_arena():
    def scenario(side):
        kvp = side.kvpool
        pool = kvp.KVPagePool(num_pages=8, layers=1, num_kv_heads=1,
                              page_size=4, head_dim=2,
                              **({"device": "cpu"} if side.is_port
                                 else {}))
        pool.set_owner_budget("a", 3)
        lease_a = pool.alloc(3, owner="a")
        assert pool.owner_held("a") == 3
        with pytest.raises(kvp.PoolExhausted, match="budget"):
            lease_a.extend(1)
        assert pool.free_pages == 5
        lease_b = pool.alloc(5, owner="b")
        assert pool.owner_held("b") == 5
        by_owner = pool.stats()["by_owner"]
        assert by_owner == {"a": 3, "b": 5}
        lease_a.release()
        lease_b.release()
        assert pool.free_pages == 8
        assert pool.stats()["by_owner"] == {}
        assert pool.owner_held("a") == 0
        return by_owner
    both(scenario)


def test_kv_default_owner_charges_unnamed_allocs():
    def scenario(side):
        pool = side.kvpool.KVPagePool(
            num_pages=4, layers=1, num_kv_heads=1, page_size=4,
            head_dim=2, **({"device": "cpu"} if side.is_port else {}))
        pool.default_owner = "alpha"
        lease = pool.alloc(2)
        held = pool.owner_held("alpha")
        assert held == 2
        lease.release()
        assert pool.owner_held("alpha") == 0
        return held
    both(scenario)


def test_named_server_charges_its_pool_and_advertises_model():
    """``InferenceServer(model_name=...)`` sets its pool's default owner
    and advertises (model, version) in ``health()`` — the server points
    the fleet's registry routing reads."""
    def scenario(side):
        model = side.lm(23, embed_dim=16, num_heads=2, mlp_dim=32,
                        num_layers=1, max_len=32)
        pool = side.kvpool.KVPagePool.for_model(model, 16, page_size=4)
        srv = side.serving.InferenceServer(model, name="t0", kv_pool=pool,
                                           model_name="alpha",
                                           model_version="v3")
        assert pool.default_owner == "alpha"
        h = srv.health()
        return {"model": h["model"], "version": h["model_version"]}
    assert both(scenario) == {"model": "alpha", "version": "v3"}


# ---------------------------------------------------------------------------
# registry-aware routing + typed NOT_FOUND on the live fleet
# ---------------------------------------------------------------------------

def test_not_found_is_typed_nonretryable_and_burns_nothing():
    def body(side, fl):
        assert side.serving.Status.NOT_FOUND \
            not in side.router.RETRYABLE_STATUSES
        rng = np.random.RandomState(0)
        r = fl.submit(feat(rng), model="ghost").result(10)
        assert r.status.value == "not_found"
        assert "ghost" in r.error
        for srv in fl.servers.values():
            assert sum(srv.metrics.counts.values()) == 0
        assert fl.router.admission.inflight() == 0
        tenants = fl.router.metrics.tenants()
        assert tenants["ghost"]["requests"] == {"not_found": 1}
        assert tenants["ghost"]["sheds"] == {"not_found": 1}
        return {"status": r.status.value, "retries":
                fl.router.metrics.retries, "ghost": tenants["ghost"]}
    both(with_multi(body))


def test_router_dispatches_on_advertised_model_only():
    def body(side, fl):
        fl.pump_once()
        h = fl.router.health_of("alpha-r0")
        assert h["model"] == "alpha" and h["model_version"] == "v1"
        rng = np.random.RandomState(1)
        res = [fl.submit(feat(rng), model="alpha").result(30)
               for _ in range(8)]
        assert all(r.status.value == "ok" for r in res)
        served = {rid: srv.metrics.counts["ok"]
                  for rid, srv in fl.servers.items()}
        assert served["beta-r0"] == 0 and served["beta-r1"] == 0
        assert served["alpha-r0"] + served["alpha-r1"] == 8
        return {"outputs": outputs(res),
                "alpha": served["alpha-r0"] + served["alpha-r1"],
                "beta": served["beta-r0"] + served["beta-r1"]}
    both(with_multi(body))


def test_unregistered_model_resolves_not_found_on_fleet():
    def body(side, fl):
        rng = np.random.RandomState(2)
        a = fl.submit(feat(rng), model="alpha").result(30)
        assert a.status.value == "ok"
        fl.router.model_registry.unregister("alpha")
        r = fl.submit(feat(rng), model="alpha").result(10)
        assert r.status.value == "not_found"
        b = fl.submit(feat(rng), model="beta").result(30)
        assert b.status.value == "ok"
        return {"statuses": statuses([a, r, b]),
                "outputs": [a.output, b.output]}
    both(with_multi(body))


def test_tenant_flood_injector_sheds_flooded_tenant_only():
    def body(side, fl):
        rng = np.random.RandomState(3)
        with side.faults.tenant_flood("alpha", rps=10 ** 6):
            ra = fl.submit(feat(rng), model="alpha").result(10)
            rb = fl.submit(feat(rng), model="beta").result(30)
        assert ra.status.value == "overloaded"
        assert "tenant_quota" in ra.error
        assert rb.status.value == "ok"
        tenants = fl.router.metrics.tenants()
        assert tenants["alpha"]["sheds"] == {"tenant_quota": 1}
        assert tenants["beta"]["shed_total"] == 0
        return {"statuses": statuses([ra, rb]), "beta": rb.output,
                "sheds": tenants["alpha"]["sheds"]}
    both(with_multi(body))


# ---------------------------------------------------------------------------
# tenant-scoped verified deploys: per-replica locks, canary, rollback
# ---------------------------------------------------------------------------

def test_model_scoped_swap_updates_only_that_tenant():
    def body(side, fl):
        x = feat(np.random.RandomState(6))
        assert fl.rolling_swap(
            params=side.small_model(seed=2).param_tree(),
            model="alpha", version="v2") == 2
        for rid, srv in fl.servers.items():
            if rid.startswith("alpha"):
                assert srv.model_version == "v2"
                assert srv.metrics.swaps == 1
            else:
                assert srv.model_version == "v1"
                assert srv.metrics.swaps == 0
        assert fl.router.model_registry.lookup("alpha") == "v2"
        swapped = {rid: srv.submit(x).result(30).output
                   for rid, srv in sorted(fl.servers.items())}
        assert fl.rollback_last_deploy(model="alpha") == 2
        assert all(s.model_version == "v1" for s in fl.servers.values())
        assert fl.router.model_registry.lookup("alpha") == "v1"
        assert fl.rollback_last_deploy(model="alpha") == 0
        return swapped
    both(with_multi(body))


def test_poisoned_tenant_deploy_never_touches_other_tenant():
    def body(side, fl):
        rng = np.random.RandomState(4)
        with pytest.raises(side.swap.SwapRejected):
            fl.rolling_swap(params=side.faults.poison_params(
                fl.servers["alpha-r0"].model.param_tree()),
                model="alpha", version="v2")
        for srv in fl.servers.values():
            assert srv.metrics.swaps == 0
        assert fl.router.model_registry.lookup("alpha") == "v1"
        r = fl.submit(feat(rng), model="beta").result(30)
        assert r.status.value == "ok"
        assert np.isfinite(np.asarray(r.output)).all()
        return {"output": r.output, "rollbacks": fl.deploy_rollbacks}
    both(with_multi(body))


def test_deploy_locks_serialize_overlap_only():
    def body(side, fl):
        with fl._deploy_table_lock:
            lk = fl._deploy_locks.setdefault("alpha-r0",
                                             threading.Lock())
        assert lk.acquire(blocking=False)
        try:
            with pytest.raises(side.swap.DeployInFlight):
                fl.rolling_swap(params=side.small_model(3).param_tree(),
                                model="alpha")
            with pytest.raises(side.swap.DeployInFlight):
                fl.rolling_swap(params=side.small_model(3).param_tree())
            n_beta = fl.rolling_swap(
                params=side.small_model(3).param_tree(),
                model="beta", version="v3")
            assert n_beta == 2
        finally:
            lk.release()
        n_alpha = fl.rolling_swap(params=side.small_model(3).param_tree(),
                                  model="alpha", version="v2")
        assert n_alpha == 2
        return {"beta": n_beta, "alpha": n_alpha,
                "versions": {rid: s.model_version
                             for rid, s in fl.servers.items()}}
    both(with_multi(body))


# ---------------------------------------------------------------------------
# per-tenant SLO rule packs
# ---------------------------------------------------------------------------

def test_per_tenant_slo_rules_fire_and_resolve_independently():
    def scenario(side):
        tel = side.telemetry
        M = side.metric_names
        t = [0.0]
        rec = tel.MetricRecorder(clock=lambda: t[0])
        eng = side.slo.SloEngine(rec, registry=tel.MetricsRegistry(),
                                 clock=lambda: t[0])
        names = {}
        for tenant in ("alpha", "beta"):
            rules = side.slo.default_serving_rules(
                "both", tenant=tenant, p99_high_s=0.5,
                for_intervals=1, resolve_intervals=1)
            for r in rules:
                eng.add_rule(r)
            names[tenant] = [r.name for r in rules]
        assert set(names["alpha"]).isdisjoint(names["beta"])
        assert "serving/alpha:both/p99" in names["alpha"]

        def feed(tenant, p99, now):
            rec.observe(M.AUTOSCALE_POOL_P99_SECONDS, p99,
                        labels={"pool": f"{tenant}:both"}, now=now)

        t[0] = 1.0
        feed("alpha", 2.0, t[0])
        feed("beta", 0.01, t[0])
        eng.evaluate(now=t[0])
        firing1 = sorted(a["rule"] for a in eng.firing())
        assert "serving/alpha:both/p99" in firing1
        assert not any(n in firing1 for n in names["beta"])
        t[0] = 2.0
        feed("alpha", 0.01, t[0])
        feed("beta", 2.0, t[0])
        eng.evaluate(now=t[0])
        firing2 = sorted(a["rule"] for a in eng.firing())
        assert "serving/alpha:both/p99" not in firing2
        assert "serving/beta:both/p99" in firing2
        return {"names": names, "firing": [firing1, firing2]}
    both(scenario)


# ---------------------------------------------------------------------------
# (model, phase) pools: the autoscaler's tenant-scoped sizing
# ---------------------------------------------------------------------------

def test_autoscaler_defaults_to_model_scoped_pools():
    def body(side, fl):
        assert side.pools.split_pool("decode") == (None, "decode")
        assert side.pools.split_pool("alpha:decode") == ("alpha",
                                                          "decode")
        asc = side.autoscale.Autoscaler(fl, lambda rid, pool: None)
        assert asc.pools == ("alpha:both", "beta:both")
        assert asc.pool_size("alpha:both") == 2
        assert asc.pool_size("beta:both") == 2
        fl.pump_once()
        sig = asc.pool_signals("alpha:both")
        assert sig["replicas"] == 2
        assert set(asc._pool_health("alpha:both")) \
            == {"alpha-r0", "alpha-r1"}
        return {"pools": asc.pools, "replicas": sig["replicas"]}
    both(with_multi(body))


# ---------------------------------------------------------------------------
# fleet snapshot fold + the run report's per-tenant view
# ---------------------------------------------------------------------------

def test_snapshot_and_run_report_carry_tenant_view(tmp_path, capsys):
    """The JAX fleet's snapshots go through ``tools/run_report.py`` as
    in the reference spec; the port's through its own fold
    (``telemetry.aggregate.read_snapshot_dir`` + ``merge_cluster``)."""
    def body(side, fl):
        d = tmp_path / side.name
        rng = np.random.RandomState(5)
        res = [fl.submit(feat(rng), model="alpha").result(30)
               for _ in range(4)]
        res += [fl.submit(feat(rng), model="beta").result(30)
                for _ in range(2)]
        assert all(r.ok for r in res)
        snap = fl.snapshot()
        assert snap["tenants"]["alpha"]["served_ok"] == 4
        assert snap["tenants"]["beta"]["served_ok"] == 2
        assert snap["router"]["registry"] == {"alpha": "v1",
                                              "beta": "v1"}
        assert "bigdl_tenant_admission_total" in snap["metrics"]
        paths = fl.write_snapshots(str(d))
        assert len(paths) == 5
        if side.is_port:
            from bigdl_tpu_torch.telemetry.aggregate import (
                merge_cluster, read_snapshot_dir)

            merged = merge_cluster(read_snapshot_dir(str(d)))
        else:
            import tools.run_report as run_report

            assert run_report.main([str(d), "--json"]) == 0
            merged = json.loads(capsys.readouterr().out)
        assert merged["tenants"]["alpha"]["served_ok"] == 4
        assert merged["tenants"]["beta"]["total"] == 2
        return {"outputs": outputs(res), "tenants": snap["tenants"],
                "merged": merged["tenants"]}
    both(with_multi(body))


# ---------------------------------------------------------------------------
# chaos e2e: noisy-neighbor isolation under flood + kill + poisoned deploy
# ---------------------------------------------------------------------------

def test_e2e_two_tenant_fleet_isolates_noisy_neighbor():
    DEADLINE = 5.0

    def scenario(side):
        with SpecDeadline(DEADLINE_S) as dl:
            fl = dl.add(multi_fleet(side, n=2, capacity=16,
                                    pump_interval_s=0.05,
                                    heartbeat_timeout=0.3,
                                    default_deadline_s=DEADLINE,
                                    max_queue=256))
            fl.start()
            rng = np.random.RandomState(7)
            try:
                for m in ("alpha", "beta"):
                    [f.result(60) for f in
                     [fl.submit(feat(rng), model=m) for _ in range(8)]]

                def beta_closed_loop(n):
                    r = np.random.RandomState(11)
                    return [fl.submit(feat(r), model="beta").result(60)
                            for _ in range(n)]

                solo = beta_closed_loop(60)
                alpha_futs = []
                fut_lock = threading.Lock()
                stop = threading.Event()

                def alpha_flood(seed):
                    r = np.random.RandomState(seed)
                    while not stop.is_set():
                        f = fl.submit(feat(r), model="alpha",
                                      deadline_s=DEADLINE)
                        with fut_lock:
                            alpha_futs.append(f)
                        time.sleep(0.001)

                floods = [threading.Thread(target=alpha_flood, args=(s,))
                          for s in range(4)]
                for th in floods:
                    th.start()
                try:
                    time.sleep(0.05)
                    with pytest.raises(side.swap.SwapRejected):
                        fl.rolling_swap(params=side.faults.poison_params(
                            fl.servers["alpha-r0"].model.param_tree()),
                            model="alpha", version="v2")
                    with side.faults.kill_replica("alpha-r0"):
                        deadline = time.monotonic() + 15
                        while "alpha-r0" in fl.router.members \
                                and time.monotonic() < deadline:
                            time.sleep(0.01)
                    assert "alpha-r0" not in fl.router.members
                    contended = beta_closed_loop(60)
                finally:
                    stop.set()
                    for th in floods:
                        th.join(timeout=30)
                alpha_res = [f.result(timeout=120) for f in alpha_futs]
                by = Counter(r.status.value for r in alpha_res)
                assert set(by) <= {"ok", "overloaded", "unavailable",
                                   "deadline_exceeded", "cancelled"}
                assert all(r.ok for r in contended)
                for r in alpha_res:
                    if r.ok:
                        assert np.isfinite(np.asarray(r.output)).all()
                for r in contended:
                    assert np.isfinite(np.asarray(r.output)).all()
                for srv in fl.servers.values():
                    assert srv.metrics.swaps == 0
                assert all(s.model_version == "v1"
                           for rid, s in fl.servers.items()
                           if rid.startswith("beta"))
                tenants = fl.router.metrics.tenants()
                assert tenants["beta"]["shed_total"] == 0
                assert tenants["alpha"]["sheds"].get("tenant_quota", 0) \
                    > 0 or by["overloaded"] > 0
                return {"solo": outputs(solo),
                        "contended": outputs(contended),
                        "beta_sheds": tenants["beta"]["shed_total"],
                        "members": fl.router.members}
            finally:
                fl.stop(timeout=15)
    both(scenario)


def test_port_tenants_share_one_device_not_parameters():
    """Two tenants built over one model object: each replica holds its
    own copy, so a tenant-scoped swap leaves the other tenant's replicas
    and the caller's model untouched."""
    model = PORT.small_model(seed=0)
    fl = PORT.serving.ServingFleet.build_multi(
        {"alpha": model, "beta": model}, n_replicas_each=1,
        pump_interval_s=0)
    x = feat(np.random.RandomState(8))
    before = PORT.forward(model, x[None])[0]
    with SpecDeadline(DEADLINE_S) as dl:
        dl.add(fl).start()
        try:
            assert fl.rolling_swap(
                params=PORT.small_model(seed=1).param_tree(),
                model="alpha") == 1
            a = fl.submit(x, model="alpha").result(30).output
            b = fl.submit(x, model="beta").result(30).output
        finally:
            fl.stop(timeout=10)
    np.testing.assert_array_equal(b, before)
    np.testing.assert_array_equal(PORT.forward(model, x[None])[0], before)
    assert not np.array_equal(a, before)
