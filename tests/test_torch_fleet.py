"""The port's serving fleet (``bigdl_tpu_torch/serving/fleet.py`` +
``router.py`` on ``resilience/elastic.py``'s membership) against the JAX
package's, on the CPU.

Every spec of ``tests/test_fleet.py`` is mirrored: the JAX fleet and the
port's fleet get the same weights, the same request stream from a numpy
seed and the same fault schedule; each scenario makes the reference's
assertions on both, and the two sides' readings — typed statuses,
membership transitions, retry / ejection / hedge / deploy counts and
outputs — must be equal (classify outputs within 1e-4, rtol 0, the
tolerance ``tests/test_torch_serving.py`` holds the server to).  Wall
clock limits of the reference (a hedge winning inside 0.7 s, the chaos
run's p99 under its deadline) are replaced by counts: the hedge fired
and won, every request resolved typed.  Each spec that starts a fleet
stops it in ``finally`` and runs under a deadline of its own.
"""
import json
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch

from _torch_fleet_sides import (JAX, PORT, SpecDeadline, both, outputs,
                                statuses)

torch.set_num_threads(1)

DEADLINE_S = 90


def feat(rng):
    return rng.rand(4).astype(np.float32)


def make_fleet(side, n=2, hedge=False, hedge_delay_s=0.02,
               heartbeat_timeout=0.4, pump_interval_s=None,
               clock=time.monotonic, ready_quorum=None,
               default_deadline_s=10.0, max_queue=64, seed=0):
    return side.serving.ServingFleet.build(
        side.small_model(seed), n_replicas=n,
        server_kw=dict(max_batch=8, max_queue=max_queue),
        heartbeat_timeout=heartbeat_timeout,
        pump_interval_s=pump_interval_s,
        ready_quorum=ready_quorum,
        clock=clock,
        router_kw=dict(default_deadline_s=default_deadline_s,
                       hedge=hedge, hedge_delay_s=hedge_delay_s,
                       clock=clock))


def with_fleet(body, **kw):
    """``body(side, fleet)`` on a started 2-replica fleet (the reference
    ``fleet`` fixture), stopped in ``finally``, under the spec deadline.
    Its bodies change no membership, so no pump thread runs: the beats of
    ``start()`` stay fresh for the deadline's length."""
    kw = dict(dict(pump_interval_s=0, heartbeat_timeout=DEADLINE_S), **kw)

    def scenario(side):
        with SpecDeadline(DEADLINE_S) as dl:
            fl = dl.add(make_fleet(side, n=2, **kw))
            fl.start()
            try:
                return body(side, fl)
            finally:
                fl.stop(timeout=10)
    return scenario


# ---------------------------------------------------------------------------
# membership: heartbeats, health, eject, readmit
# ---------------------------------------------------------------------------

def test_agent_publishes_heartbeat_and_health_snapshot():
    def scenario(side):
        kv = side.elastic.InMemoryKV()
        srv = side.serving.InferenceServer(side.small_model(), name="rA",
                                           max_batch=4).start()
        try:
            agent = side.serving.ReplicaAgent("rA", srv, kv)
            agent.coordinator.bootstrap(["rA"])
            agent.pump()
            beats = agent.coordinator.beats()
            assert "rA" in beats and beats["rA"]["step"] == 1
            h = side.router.read_health(kv, "rA")
            assert h["ready"] is True and h["healthy"] is True
            assert h["breaker_state"] == "closed"
            assert h["queue_depth"] == 0
            assert h["incarnation"] == 0
            assert "p99_s" in h and "ts" in h
            return {k: h[k] for k in ("ready", "healthy", "draining",
                                      "queue_depth", "breaker_state",
                                      "role", "incarnation", "served_ok",
                                      "requests_total")}
        finally:
            srv.stop(timeout=10)
    both(scenario)


def test_missed_heartbeats_eject_then_rejoin_readmits():
    def scenario(side):
        t = [0.0]
        with SpecDeadline(DEADLINE_S) as dl:
            fl = dl.add(make_fleet(side, n=3, heartbeat_timeout=2.0,
                                   pump_interval_s=0, clock=lambda: t[0]))
            fl.start()
            try:
                seen = [fl.router.members]
                t[0] = 3.0
                fl.agents["r1"].pump()
                fl.agents["r2"].pump()
                fl.router.refresh()
                assert fl.router.members == ("r1", "r2")
                assert fl.router.ejections == 1
                n, members = fl.router.coordinator.membership()
                assert n == 1 and members == ("r1", "r2")
                seen.append(fl.router.members)
                fl.agents["r0"].pump()
                fl.router.refresh()
                assert fl.router.members == ("r0", "r1", "r2")
                assert fl.router.readmissions == 1
                assert fl.router.coordinator.membership()[0] == 2
                seen.append(fl.router.members)
                return {"members": seen, "ejections": fl.router.ejections,
                        "readmissions": fl.router.readmissions}
            finally:
                fl.stop(timeout=10)
    both(scenario)


def test_partition_kv_ejects_and_heals():
    def scenario(side):
        t = [0.0]
        with SpecDeadline(DEADLINE_S) as dl:
            fl = dl.add(make_fleet(side, n=2, heartbeat_timeout=2.0,
                                   pump_interval_s=0, clock=lambda: t[0]))
            fl.start()
            try:
                with side.faults.partition_kv("r1"):
                    t[0] = 3.0
                    fl.pump_once()
                    assert fl.router.members == ("r0",)
                    during = fl.router.members
                fl.pump_once()
                assert fl.router.members == ("r0", "r1")
                assert fl.router.readmissions == 1
                return {"during": during, "after": fl.router.members,
                        "readmissions": fl.router.readmissions}
            finally:
                fl.stop(timeout=10)
    both(scenario)


def test_breaker_open_ejects_and_recovery_readmits():
    def scenario(side):
        with SpecDeadline(DEADLINE_S) as dl:
            fl = dl.add(make_fleet(side, n=2, pump_interval_s=0))
            fl.start()
            try:
                fl.servers["r1"].breaker.record_failure(fatal=True)
                assert fl.servers["r1"].breaker.state == "open"
                fl.pump_once()
                assert fl.router.members == ("r0",)
                assert fl.router.ejections == 1
                fl.servers["r1"].breaker.record_success()
                fl.pump_once()
                assert fl.router.members == ("r0", "r1")
                return {"ejections": fl.router.ejections,
                        "readmissions": fl.router.readmissions}
            finally:
                fl.stop(timeout=10)
    both(scenario)


def test_kill_replica_ejects_and_requests_keep_resolving():
    def scenario(side):
        with SpecDeadline(DEADLINE_S) as dl:
            fl = dl.add(make_fleet(side, n=3, heartbeat_timeout=0.3,
                                   pump_interval_s=0.05))
            fl.start()
            rng = np.random.RandomState(0)
            try:
                warm = [f.result(60) for f in
                        [fl.submit(feat(rng)) for _ in range(6)]]
                with side.faults.kill_replica("r1"):
                    deadline = time.monotonic() + 15
                    while "r1" in fl.router.members \
                            and time.monotonic() < deadline:
                        time.sleep(0.02)
                assert "r1" not in fl.router.members
                assert fl.router.ejections >= 1
                res = [f.result(60) for f in
                       [fl.submit(feat(rng)) for _ in range(12)]]
                assert all(r.ok for r in res)
                assert not fl.servers["r1"].healthy()
                return {"statuses": statuses(warm + res),
                        "outputs": outputs(warm + res),
                        "members": fl.router.members}
            finally:
                fl.stop(timeout=10)
    both(scenario)


# ---------------------------------------------------------------------------
# routing: failover retries, deadline budget, hedging
# ---------------------------------------------------------------------------

def test_routes_and_matches_direct_forward():
    def body(side, fleet):
        rng = np.random.RandomState(0)
        xs = [feat(rng) for _ in range(12)]
        res = [f.result(60) for f in [fleet.submit(x) for x in xs]]
        assert all(r.ok for r in res)
        direct = side.forward(fleet.servers["r0"].model, np.stack(xs))
        np.testing.assert_allclose(np.stack([r.output for r in res]),
                                   direct, atol=1e-6)
        snap = fleet.router.snapshot()
        assert snap["metrics"]["served_ok"] == 12
        return {"outputs": outputs(res), "served_ok": 12}
    both(with_fleet(body))


def test_failed_replica_retries_on_another_with_budget():
    def body(side, fleet):
        rng = np.random.RandomState(0)
        [f.result(60) for f in [fleet.submit(feat(rng)) for _ in range(4)]]
        before = fleet.router.metrics.retries
        with side.faults.serving_step_failures(times=1,
                                               server="r0") as burst:
            res = [fleet.submit(feat(rng), deadline_s=10.0).result(60)
                   for _ in range(6)]
            assert burst["fired"] == 1
        assert all(r.ok for r in res)
        assert fleet.router.metrics.retries >= before + 1
        return {"statuses": statuses(res), "outputs": outputs(res),
                "retries": fleet.router.metrics.retries - before}
    both(with_fleet(body))


def test_deadline_budget_exhausted_resolves_typed():
    def body(side, fleet):
        rng = np.random.RandomState(0)
        [f.result(60) for f in [fleet.submit(feat(rng)) for _ in range(2)]]
        with side.faults.serving_step_latency(0.5, times=8):
            slow = fleet.submit(feat(rng), deadline_s=0.15).result(30)
        assert slow.status.value == "deadline_exceeded"
        t0 = time.monotonic()
        dead = fleet.submit(feat(rng), deadline_s=-1.0).result(10)
        assert dead.status.value == "deadline_exceeded"
        assert time.monotonic() - t0 < 1.0
        return statuses([slow, dead])
    both(with_fleet(body))


def test_no_ready_replica_degrades_typed():
    def scenario(side):
        with SpecDeadline(DEADLINE_S) as dl:
            fl = dl.add(make_fleet(side, n=2, pump_interval_s=0))
            fl.start()
            try:
                rng = np.random.RandomState(0)
                [f.result(60) for f in
                 [fl.submit(feat(rng)) for _ in range(2)]]
                for srv in fl.servers.values():
                    srv.drain(timeout=10)
                fl.pump_once()
                r = fl.submit(feat(rng)).result(30)
                assert r.status.value in ("unavailable", "cancelled",
                                          "internal_error")
                assert r.error
                return {"status": r.status.value,
                        "members": fl.router.members}
            finally:
                fl.stop(timeout=10)
    both(scenario)


def test_hedge_fires_after_delay_and_hedge_wins():
    def scenario(side):
        with SpecDeadline(DEADLINE_S) as dl:
            fl = dl.add(make_fleet(side, n=2, hedge=True,
                                   hedge_delay_s=0.05))
            fl.start()
            rng = np.random.RandomState(0)
            try:
                [f.result(60) for f in
                 [fl.submit(feat(rng)) for _ in range(4)]]
                time.sleep(0.1)
                fired0 = fl.router.metrics.hedges_fired
                won0 = fl.router.metrics.hedges_won
                with side.faults.delay_replica("r0", 0.8, times=4):
                    r = fl.submit(feat(rng), deadline_s=10.0).result(30)
                assert r.ok
                fired = fl.router.metrics.hedges_fired - fired0
                won = fl.router.metrics.hedges_won - won0
                # the winner was the hedge, not the slowed primary
                assert fired >= 1 and won >= 1
                assert fl.router.metrics.snapshot()["served_ok"] == 5
                return {"status": r.status.value, "output": r.output,
                        "fired": fired, "won": won}
            finally:
                fl.stop(timeout=10)
    both(scenario)


def test_hedge_disabled_never_fires():
    def body(side, fleet):
        rng = np.random.RandomState(0)
        with side.faults.serving_step_latency(0.1, times=2):
            r = fleet.submit(feat(rng)).result(30)
        assert r.ok
        assert fleet.router.metrics.hedges_fired == 0
        return {"output": r.output, "hedges": 0}
    both(with_fleet(body))


# ---------------------------------------------------------------------------
# rolling verified deploys
# ---------------------------------------------------------------------------

def test_rolling_swap_installs_on_every_replica():
    def body(side, fleet):
        rng = np.random.RandomState(0)
        x = feat(rng)
        [f.result(60) for f in [fleet.submit(x) for _ in range(4)]]
        twin = side.small_model(seed=1)
        assert fleet.rolling_swap(params=twin.param_tree()) == 2
        assert fleet.deploys == 1
        want = side.forward(twin, x[None])[0]
        got = []
        for srv in fleet.servers.values():
            r = srv.submit(x).result(60)
            assert r.ok
            np.testing.assert_allclose(r.output, want, atol=1e-6)
            assert srv.metrics.swaps == 1
            got.append(r.output)
        return got
    both(with_fleet(body))


def test_rolling_swap_from_verified_checkpoint(tmp_path):
    def body(side, fleet):
        d = tmp_path / side.name
        d.mkdir()
        rng = np.random.RandomState(0)
        x = feat(rng)
        [f.result(60) for f in [fleet.submit(x) for _ in range(2)]]
        twin = side.small_model(seed=1)
        good = str(d / "model.1")
        side.save_params(twin, good)
        assert fleet.rolling_swap(path=good) == 2
        bad = str(d / "model.2")
        side.save_params(twin, bad)
        side.faults.bit_flip(bad)
        with pytest.raises(side.swap.SwapRejected, match="crc32c"):
            fleet.rolling_swap(path=bad)
        for srv in fleet.servers.values():
            assert srv.metrics.swaps == 1
        return fleet.servers["r1"].submit(x).result(60).output
    both(with_fleet(body))


def test_poisoned_deploy_rejected_fleetwide_nothing_served():
    def body(side, fleet):
        rng = np.random.RandomState(0)
        x = feat(rng)
        before = fleet.submit(x).result(60).output
        with pytest.raises(side.swap.SwapRejected,
                           match="rolling deploy halted"):
            fleet.rolling_swap(params=side.faults.poison_params(
                fleet.servers["r0"].model.param_tree()))
        assert fleet.deploy_rollbacks == 1
        after = fleet.submit(x).result(60)
        assert after.ok
        np.testing.assert_allclose(after.output, before, atol=1e-6)
        for srv in fleet.servers.values():
            assert srv.metrics.swaps == 0
        return {"before": before, "after": after.output,
                "rollbacks": fleet.deploy_rollbacks}
    both(with_fleet(body))


def test_midway_rejection_rolls_back_already_swapped():
    def scenario(side):
        with SpecDeadline(DEADLINE_S) as dl:
            fl = dl.add(make_fleet(side, n=3, pump_interval_s=0))
            fl.start()
            rng = np.random.RandomState(0)
            x = feat(rng)
            try:
                before = fl.submit(x).result(60).output
                twin = side.small_model(seed=1)
                with side.faults.serving_step_failures(times=1,
                                                       server="r2"):
                    with pytest.raises(side.swap.SwapRejected,
                                       match="halted at r2.*2 already-"
                                             "swapped"):
                        fl.rolling_swap(params=twin.param_tree())
                assert fl.deploy_rollbacks == 1
                res = [srv.submit(x).result(60)
                       for srv in fl.servers.values()]
                for r in res:
                    assert r.ok
                    np.testing.assert_allclose(r.output, before,
                                               atol=1e-6)
                return {"outputs": outputs(res),
                        "swaps": [s.metrics.swaps
                                  for s in fl.servers.values()],
                        "rolled_back": [s.metrics.swaps_rolled_back
                                        for s in fl.servers.values()]}
            finally:
                fl.stop(timeout=10)
    both(scenario)


def test_alert_driven_rollback_rides_verified_path_and_accounts():
    def scenario(side):
        with SpecDeadline(DEADLINE_S) as dl:
            fl = dl.add(make_fleet(side, n=3, pump_interval_s=0))
            fl.start()
            rng = np.random.RandomState(0)
            x = feat(rng)
            try:
                before = fl.submit(x).result(60).output
                twin = side.small_model(seed=1)
                assert fl.rolling_swap(params=twin.param_tree()) == 3
                assert fl.rollback_last_deploy() == 3
                assert fl.deploy_rollbacks == 1
                after = fl.submit(x).result(60)
                assert after.ok
                np.testing.assert_allclose(after.output, before,
                                           atol=1e-6)
                for srv in fl.servers.values():
                    assert srv.metrics.swaps == 1
                    assert srv.metrics.swaps_rolled_back == 1
                assert fl.rollback_last_deploy() == 0
                assert fl.deploy_rollbacks == 1
                return {"after": after.output,
                        "rollbacks": fl.deploy_rollbacks}
            finally:
                fl.stop(timeout=10)
    both(scenario)


def test_quorum_guard_refuses_degraded_deploy():
    def scenario(side):
        with SpecDeadline(DEADLINE_S) as dl:
            fl = dl.add(make_fleet(side, n=4, ready_quorum=3,
                                   pump_interval_s=0))
            fl.start()
            rng = np.random.RandomState(0)
            x = feat(rng)
            try:
                before = fl.submit(x).result(60).output
                fl.servers["r2"].stop(timeout=10)
                fl.servers["r3"].stop(timeout=10)
                with pytest.raises(side.fleet.FleetQuorumError,
                                   match="quorum"):
                    fl.rolling_swap(
                        params=side.small_model(seed=1).param_tree())
                r = fl.submit(x).result(60)
                assert r.ok
                np.testing.assert_allclose(r.output, before, atol=1e-6)
                return {"output": r.output,
                        "swaps": [s.metrics.swaps
                                  for s in fl.servers.values()]}
            finally:
                fl.stop(timeout=10)
    both(scenario)


# ---------------------------------------------------------------------------
# fleet telemetry: merged registries, prometheus, the run report
# ---------------------------------------------------------------------------

def test_snapshot_merges_per_replica_registries():
    def body(side, fleet):
        rng = np.random.RandomState(0)
        [f.result(60) for f in
         [fleet.submit(feat(rng)) for _ in range(10)]]
        snap = fleet.snapshot()
        per = snap["replicas"]
        assert sum(p["served_ok"] for p in per.values()) == 10
        merged = snap["metrics"]["bigdl_serving_requests_total"]
        ok_series = [s for s in merged["series"]
                     if s["labels"] == {"status": "ok"}]
        assert ok_series and ok_series[0]["value"] == 10
        assert snap["router"]["metrics"]["served_ok"] == 10
        assert snap["membership"]["members"] == ["r0", "r1"]
        assert snap["goodput_per_chip"]["chips"] == 2
        return {"ok": ok_series[0]["value"],
                "members": snap["membership"]["members"],
                "families": sorted(snap["metrics"]),
                "chips": snap["goodput_per_chip"]["chips"]}
    both(with_fleet(body))


def test_prometheus_carries_swap_and_hedge_counters():
    def body(side, fleet):
        rng = np.random.RandomState(0)
        [f.result(60) for f in [fleet.submit(feat(rng)) for _ in range(2)]]
        fleet.rolling_swap(params=side.small_model(seed=1).param_tree())
        with pytest.raises(side.swap.SwapRejected):
            fleet.rolling_swap(params=side.faults.poison_params(
                fleet.servers["r0"].model.param_tree()))
        fleet.router.metrics.record_hedge()
        fleet.router.metrics.record_hedge(won=True)
        text = fleet.to_prometheus()
        lines = ['bigdl_serving_swaps_total{outcome="installed"} 1.0',
                 'bigdl_serving_swaps_total{outcome="rejected"} 1.0',
                 'bigdl_serving_hedges_total{event="fired"} 1.0',
                 'bigdl_serving_hedges_total{event="won"} 1.0']
        for line in lines:
            assert line in text
        return [line in text for line in lines]
    both(with_fleet(body))


def test_write_snapshots_renders_through_run_report(tmp_path, capsys):
    """The JAX fleet's snapshots go through ``tools/run_report.py`` as
    in the reference spec; the port's through its own fold
    (``telemetry.aggregate.read_snapshot_dir`` + ``merge_cluster``)."""
    def body(side, fleet):
        d = tmp_path / side.name
        rng = np.random.RandomState(0)
        [f.result(60) for f in [fleet.submit(feat(rng)) for _ in range(6)]]
        paths = fleet.write_snapshots(str(d))
        assert len(paths) == 3
        if side.is_port:
            from bigdl_tpu_torch.telemetry.aggregate import (
                merge_cluster, read_snapshot_dir)

            merged = merge_cluster(read_snapshot_dir(str(d)))
        else:
            import tools.run_report as run_report

            assert run_report.main([str(d), "--json"]) == 0
            merged = json.loads(capsys.readouterr().out)
        assert sorted(merged["hosts"]) == ["fleet-router", "r0", "r1"]
        fam = merged["metrics"]["bigdl_serving_requests_total"]
        ok = [s for s in fam["series"] if s["labels"] == {"status": "ok"}]
        assert ok and ok[0]["value"] == 6
        assert "bigdl_serving_hedges_total" in merged["metrics"]
        return {"hosts": sorted(merged["hosts"]), "ok": ok[0]["value"]}
    both(with_fleet(body))


# ---------------------------------------------------------------------------
# chaos e2e: a 4-replica fleet under load absorbs a replica kill AND a
# poisoned rolling deploy mid-flight
# ---------------------------------------------------------------------------

def test_e2e_fleet_survives_replica_kill_and_poisoned_deploy():
    """Which requests land during the failover depends on thread timing,
    so the two sides are held to the same invariants, not to the same
    per-request statuses: every request resolves typed, more than half
    OK, every OK output finite, nothing installed, the fleet settled at
    the same three members."""
    DEADLINE = 5.0

    def scenario(side):
        with SpecDeadline(DEADLINE_S) as dl:
            fl = dl.add(make_fleet(side, n=4, hedge=True,
                                   hedge_delay_s=0.05,
                                   heartbeat_timeout=0.3,
                                   pump_interval_s=0.05,
                                   default_deadline_s=DEADLINE,
                                   max_queue=256))
            fl.start()
            N = 160
            futs = [None] * N
            errs = []

            def client(lo, hi, seed):
                r = np.random.RandomState(seed)
                try:
                    for i in range(lo, hi):
                        futs[i] = fl.submit(r.rand(4).astype(np.float32),
                                            deadline_s=DEADLINE)
                        time.sleep(0.004)
                except Exception as e:  # pragma: no cover - fail below
                    errs.append(e)

            threads = [threading.Thread(target=client,
                                        args=(k * 40, (k + 1) * 40, k))
                       for k in range(N // 40)]
            try:
                rng = np.random.RandomState(99)
                [f.result(60) for f in
                 [fl.submit(feat(rng)) for _ in range(8)]]
                for t in threads:
                    t.start()
                time.sleep(0.08)
                with side.faults.kill_replica("r1"):
                    deadline = time.monotonic() + 15
                    while "r1" in fl.router.members \
                            and time.monotonic() < deadline:
                        time.sleep(0.01)
                assert "r1" not in fl.router.members
                with pytest.raises(side.swap.SwapRejected):
                    fl.rolling_swap(params=side.faults.poison_params(
                        fl.servers["r0"].model.param_tree()))
                for t in threads:
                    t.join(timeout=60)
                assert not errs
                res = [f.result(timeout=120) for f in futs]
                by = Counter(r.status.value for r in res)
                assert sum(by.values()) == N
                assert set(by) <= {"ok", "overloaded", "unavailable",
                                   "deadline_exceeded", "internal_error",
                                   "cancelled"}
                assert by["ok"] > N * 0.5
                for r in res:
                    if r.ok:
                        assert np.isfinite(np.asarray(r.output)).all()
                for srv in fl.servers.values():
                    assert srv.metrics.swaps == 0
                assert fl.router.members == ("r0", "r2", "r3")
                snap = fl.snapshot()
                assert snap["membership"]["ejections"] >= 1
                return {"resolved": sum(by.values()),
                        "members": fl.router.members,
                        "swaps": [s.metrics.swaps
                                  for s in fl.servers.values()]}
            finally:
                fl.stop(timeout=15)
    both(scenario)


def test_fleet_replicas_hold_their_own_parameters():
    """The port's swap copies into its server's model in place, so
    ``ServingFleet.build`` gives every replica its own copy of the
    model: a swap on one replica leaves the others and the caller's
    model as they were."""
    model = PORT.small_model(seed=0)
    fl = PORT.serving.ServingFleet.build(model, n_replicas=2,
                                         pump_interval_s=0)
    mods = [srv.model for srv in fl.servers.values()]
    assert mods[0] is not mods[1] and model not in mods
    x = feat(np.random.RandomState(0))
    with SpecDeadline(DEADLINE_S) as dl:
        dl.add(fl).start()
        try:
            before = PORT.forward(model, x[None])
            fl.servers["r0"].swap_params(
                params=PORT.small_model(seed=1).param_tree())
            got0 = fl.servers["r0"].submit(x).result(60).output
            got1 = fl.servers["r1"].submit(x).result(60).output
        finally:
            fl.stop(timeout=10)
    np.testing.assert_array_equal(PORT.forward(model, x[None]), before)
    np.testing.assert_array_equal(got1, before[0])
    assert not np.array_equal(got0, before[0])


def test_swaps_under_concurrent_traffic_never_serve_a_torn_model():
    """Stress: client threads hammer a two-replica fleet (interpreter
    switch interval shortened) while rolling swaps alternate two
    parameter sets.  The port's swap copies into each replica's model in
    place under its model lock, so every answer must be one set's output
    exactly — a batch that read half-copied parameters would match
    neither."""
    import sys

    a, b = PORT.small_model(seed=1), PORT.small_model(seed=2)
    x = feat(np.random.RandomState(9))
    want = [PORT.forward(m, x[None])[0] for m in (a, b)]
    trees = [a.param_tree(), b.param_tree()]
    fl = make_fleet(PORT, n=2, pump_interval_s=0, max_queue=256)
    old = sys.getswitchinterval()
    results, errs = [], []

    def client():
        try:
            for _ in range(40):
                results.append(fl.submit(x).result(60))
        except Exception as e:  # pragma: no cover - fail below
            errs.append(e)

    with SpecDeadline(DEADLINE_S) as dl:
        dl.add(fl).start()
        sys.setswitchinterval(1e-5)
        try:
            fl.rolling_swap(params=trees[0])
            threads = [threading.Thread(target=client) for _ in range(6)]
            for t in threads:
                t.start()
            swaps = 0
            while any(t.is_alive() for t in threads) and swaps < 200:
                fl.rolling_swap(params=trees[swaps % 2])
                swaps += 1
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
        finally:
            sys.setswitchinterval(old)
            fl.stop(timeout=10)
    assert not errs and len(results) == 240
    assert swaps >= 2
    assert all(r.ok for r in results)
    for r in results:
        assert any(np.array_equal(r.output, w) for w in want), r.output
