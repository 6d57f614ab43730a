"""The port's hot swap on the CPU (``InferenceServer.swap_params``,
``serving/swap.py``; ``tests/test_serving.py``'s hot-swap specs): the
swap changes outputs between batches, the canary refuses poisoned
params, a verified checkpoint installs and a bit-flipped one is refused
and quarantined, the swap counters; the generate paths (unpaged and
paged, bf16 casts) serve the new params, a swap issued while a generate
is in flight waits for it, and ``serving_step_failures`` trips the
breaker through the server's fault hook.  Candidate params come from the
JAX package where an output is held against it.
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

import jax

from bigdl_tpu import nn as jnn
from bigdl_tpu.utils.rng import RNG as JRNG
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.resilience import faults
from bigdl_tpu_torch.serving import (InferenceServer, KVPagePool, Status,
                                     SwapRejected)
from bigdl_tpu_torch.serving.breaker import OPEN, CircuitBreaker
from bigdl_tpu_torch.utils import file_io
from bigdl_tpu_torch.utils.tree import tree_leaves, tree_map

torch.set_num_threads(1)

TIMEOUT = 60


def small_model(seed=0):
    g = torch.Generator().manual_seed(seed)
    return nn.Sequential(nn.Linear(4, 8, device="cpu", generator=g),
                         nn.Tanh(device="cpu"),
                         nn.Linear(8, 3, device="cpu", generator=g),
                         nn.LogSoftMax(device="cpu"), device="cpu")


def jax_twin(seed=3):
    """A JAX classifier of the same shape and its param tree as tensors."""
    JRNG().set_seed(seed)
    jm = jnn.Sequential(jnn.Linear(4, 8), jnn.Tanh(), jnn.Linear(8, 3),
                        jnn.LogSoftMax())
    tree = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  jm.param_tree())
    return jm, tree


def _assert_equal(got, want):
    assert torch.equal(got, want)


def feat(rng):
    return rng.rand(4).astype(np.float32)


@pytest.fixture
def server():
    srv = InferenceServer(small_model(), max_batch=8, max_queue=32,
                          breaker=CircuitBreaker(failure_threshold=3,
                                                 reset_timeout=0.2),
                          name="r0")
    srv.start()
    yield srv
    srv.stop(timeout=10)


def test_hot_swap_changes_outputs_atomically(server):
    x = feat(np.random.RandomState(0))
    before = server.submit(x).result(timeout=TIMEOUT).output
    jm, tree = jax_twin()
    assert server.swap_params(params=tree)
    after = server.submit(x).result(timeout=TIMEOUT).output
    np.testing.assert_allclose(after, np.asarray(jm.forward(x[None]))[0],
                               atol=1e-6)
    assert not np.allclose(before, after)
    assert server.metrics.swaps == 1
    verify_s, canary_s, install_s = server.last_swap_s
    assert min(verify_s, canary_s, install_s) >= 0
    # current_params are copies of what serves
    params, _ = server.current_params()
    jax.tree_util.tree_map(lambda g, w: _assert_equal(g, w), params, tree)
    tree_leaves(params)[0].add_(1.0)
    assert server.submit(x).result(timeout=TIMEOUT).output.tolist() == \
        after.tolist()


def test_hot_swap_canary_rejects_poisoned_params(server):
    x = feat(np.random.RandomState(0))
    before = server.submit(x).result(timeout=TIMEOUT).output
    with pytest.raises(SwapRejected, match="non-finite"):
        server.swap_params(
            params=faults.poison_params(server.model.param_tree()))
    after = server.submit(x).result(timeout=TIMEOUT)
    assert after.ok
    np.testing.assert_array_equal(after.output, before)
    assert server.metrics.swap_rollbacks == 1
    # before any batch the canary is the params' finiteness
    fresh = InferenceServer(small_model())
    with pytest.raises(SwapRejected, match="non-finite"):
        fresh.swap_params(params=faults.poison_params(
            fresh.model.param_tree()))
    with pytest.raises(ValueError):
        fresh.swap_params()


def test_hot_swap_from_verified_checkpoint(tmp_path, server):
    x = feat(np.random.RandomState(0))
    server.submit(x).result(timeout=TIMEOUT)
    jm, tree = jax_twin()
    twin = small_model(seed=5)
    twin.set_param_tree(tree)
    good = str(tmp_path / "model.1")
    file_io.save({"params": twin.param_tree(),
                  "buffers": twin.buffer_tree()}, good, atomic=True,
                 checksum=True)
    assert server.swap_params(path=good)
    got = server.submit(x).result(timeout=TIMEOUT).output
    np.testing.assert_allclose(got, np.asarray(jm.forward(x[None]))[0],
                               atol=1e-6)
    # a bit-flipped checkpoint: refused, quarantined, the params keep
    bad = str(tmp_path / "model.2")
    file_io.save({"params": small_model(seed=6).param_tree(),
                  "buffers": twin.buffer_tree()}, bad, atomic=True,
                 checksum=True)
    faults.bit_flip(bad)
    with pytest.raises(SwapRejected, match="crc32c"):
        server.swap_params(path=bad)
    assert os.path.exists(bad + ".corrupt")
    res = server.submit(x).result(timeout=TIMEOUT)
    assert res.ok and res.output.tolist() == got.tolist()
    # the swap counters in the metrics and their exposition
    assert server.metrics.swaps == 1
    assert server.metrics.swap_rollbacks == 1
    text = server.metrics.to_prometheus()
    assert 'bigdl_serving_swaps_total{outcome="installed"} 1' in text
    assert 'bigdl_serving_swaps_total{outcome="rejected"} 1' in text


def test_a_tree_that_does_not_fit_is_refused_untouched(server):
    x = feat(np.random.RandomState(0))
    before = server.submit(x).result(timeout=TIMEOUT).output
    g = torch.Generator().manual_seed(1)
    wider = nn.Sequential(nn.Linear(4, 8, device="cpu", generator=g),
                          nn.Tanh(device="cpu"),
                          nn.Linear(8, 5, device="cpu", generator=g),
                          nn.LogSoftMax(device="cpu"), device="cpu")
    tree = wider.param_tree()
    with pytest.raises(SwapRejected, match="do not fit"):
        server.swap_params(params=tree)
    del tree["2"]
    with pytest.raises(SwapRejected, match="missing"):
        server.swap_params(params=tree)
    assert server.submit(x).result(timeout=TIMEOUT).output.tolist() == \
        before.tolist()
    assert server.metrics.swap_rollbacks == 2


def test_canary_failure_is_a_typed_rejection(server):
    x = feat(np.random.RandomState(0))
    before = server.submit(x).result(timeout=TIMEOUT).output
    _, tree = jax_twin()
    with faults.serving_step_failures(times=1, server="other"):
        assert server.swap_params(params=tree, version="v2")
    assert server.model_version == "v2"
    with faults.serving_step_failures(times=1, server="r0") as entry:
        with pytest.raises(SwapRejected, match="canary batch failed"):
            server.swap_params(params=small_model().param_tree())
    assert entry["fired"] == 1
    assert not np.allclose(server.submit(x).result(timeout=TIMEOUT).output,
                           before)


def test_serving_step_failures_trip_the_breaker(server):
    x = feat(np.random.RandomState(1))
    with faults.serving_step_failures(times=3) as entry:
        for _ in range(3):
            res = server.submit(x).result(timeout=TIMEOUT)
            assert res.status is Status.INTERNAL_ERROR
            assert "injected serving step failure" in res.error
    assert entry["fired"] == 3
    assert server.breaker.state == OPEN
    assert server.submit(x).result(timeout=TIMEOUT).status is \
        Status.UNAVAILABLE
    time.sleep(0.3)                       # past the breaker's reset
    assert server.submit(x).result(timeout=TIMEOUT).ok


# ----------------------------------------------------------------------
# the generate paths
# ----------------------------------------------------------------------

V = 29
LM_CFG = dict(embed_dim=16, num_heads=2, mlp_dim=32, num_layers=2,
              max_len=32)


def _lm(seed):
    return TransformerLM(V, **LM_CFG, device="cpu",
                         generator=torch.Generator().manual_seed(seed))


def _prompts(n, T0=6, seed=0):
    return np.random.RandomState(seed).randint(
        1, V + 1, size=(n, T0)).astype(np.int32)


def _server(model, paged, **kw):
    if paged:
        kw["kv_pool"] = KVPagePool.for_model(model, 24, page_size=4)
    return InferenceServer(model, max_batch=4, **kw).start()


def _streams(server, prompts, max_new=8):
    futs = [server.submit_generate(p, max_new) for p in prompts]
    res = [f.result(timeout=TIMEOUT) for f in futs]
    assert all(r.ok for r in res), [r.error for r in res]
    return [r.output.tolist() for r in res]


def _fresh_streams(params, prompts, paged, dtype):
    model = _lm(seed=11)
    model.set_param_tree(params)
    srv = _server(model, paged, generate_dtype=dtype)
    try:
        return _streams(srv, prompts)
    finally:
        srv.stop(timeout=10)


@pytest.mark.parametrize("paged", [False, True], ids=["unpaged", "paged"])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_generate_path_serves_the_new_params(tmp_path, paged, dtype):
    prompts = _prompts(3)
    model = _lm(seed=0)
    srv = _server(model, paged, generate_dtype=dtype)
    try:
        old = _streams(srv, prompts)
        new_model = _lm(seed=1)
        path = str(tmp_path / "model.8")
        file_io.save({"params": new_model.param_tree(),
                      "buffers": new_model.buffer_tree()}, path,
                     atomic=True, checksum=True)
        assert srv.swap_params(path=path)
        got = _streams(srv, prompts)
    finally:
        srv.stop(timeout=10)
    want = _fresh_streams(new_model.param_tree(), prompts, paged, dtype)
    assert got == want
    assert got != old


@pytest.mark.parametrize("paged", [False, True], ids=["unpaged", "paged"])
def test_swap_during_an_in_flight_generate_waits_for_it(paged):
    """The worker holds the model lock for a whole batch: a swap issued
    while a generate runs installs after it, so the in-flight stream is
    the old params' and the next one the new params'."""
    prompts = _prompts(1, seed=4)
    model = _lm(seed=0)
    old_params = tree_map(lambda t: t.detach().clone(), model.param_tree())
    new_params = _lm(seed=1).param_tree()
    srv = _server(model, paged)
    try:
        with faults.serving_step_latency(0.2, times=2) as entry:
            fut = srv.submit_generate(prompts[0], 8)
            deadline = time.monotonic() + TIMEOUT
            while entry["fired"] == 0 and time.monotonic() < deadline:
                time.sleep(0.005)
            assert entry["fired"] >= 1, "the generate never started"
            done = threading.Event()
            swapper = threading.Thread(
                target=lambda: (srv.swap_params(params=new_params),
                                done.set()))
            swapper.start()
            in_flight = fut.result(timeout=TIMEOUT)
            swapper.join(timeout=TIMEOUT)
        assert done.is_set() and not swapper.is_alive()
        assert in_flight.ok
        nxt = _streams(srv, prompts)
    finally:
        srv.stop(timeout=10)
    assert [in_flight.output.tolist()] == _fresh_streams(
        old_params, prompts, paged, None)
    assert nxt == _fresh_streams(new_params, prompts, paged, None)
    assert nxt != [in_flight.output.tolist()]
