"""The port's paged serving against the JAX package, in f32 on the CPU:
the page allocator (``serving/kvpool.py``), the paged decode
(``models/generate.py``: the page table, the page-window block mask,
whose prefill reaches ``block_sparse_attention``), the server's paged
loop with its typed outcomes, the prefill/decode roles and the
crc-sealed handoff (``serving/pools.py``), whose f32 wire format is the
JAX package's.  Weights cross with ``interop.load_param_tree``."""
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn  # noqa: F401 — registry
from bigdl_tpu.models import generate as jgen
from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.serving.kvpool import KVPagePool as JaxPool
from bigdl_tpu.serving.pools import deserialize_handoff as jax_deserialize
from bigdl_tpu.serving.pools import serialize_handoff as jax_serialize
from bigdl_tpu.utils.rng import RNG as JRNG
from bigdl_tpu.visualization.crc32c import crc32c as jax_crc32c
from bigdl_tpu.visualization.crc32c import masked_crc32c as jax_masked
from bigdl_tpu_torch.interop import load_param_tree
from bigdl_tpu_torch.models import generate as tgen
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.serving import (HandoffCorrupt, InferenceServer,
                                     KVPagePool, PoolExhausted, Status)
from bigdl_tpu_torch.serving.kvpool import page_bucket_for, page_bucket_ladder
from bigdl_tpu_torch.serving.pools import (ROLES, deserialize_handoff,
                                           pool_members,
                                           serialize_handoff, serves_phase)
from bigdl_tpu_torch.visualization import crc32c, masked_crc32c

# The suite runs in several processes at once: one intra-op thread each
torch.set_num_threads(1)

VOCAB, TMAX = 23, 32
CFG = dict(embed_dim=16, num_heads=2, mlp_dim=32, num_layers=1,
           max_len=TMAX)

#: one (JAX, port) pair per architecture for the whole module: the JAX
#: paged programs compile once per (model, page_size) and shape
_PAIRS = {}


def _pair(**kw):
    key = tuple(sorted(kw.items()))
    if key not in _PAIRS:
        JRNG().set_seed(4)
        jm = JaxLM(VOCAB, **CFG, **kw)
        tm = TransformerLM(VOCAB, **CFG, **kw, device="cpu")
        load_param_tree(tm, jax.tree_util.tree_map(np.asarray,
                                                   jm.param_tree()))
        jm.evaluate()
        tm.evaluate()
        _PAIRS[key] = (jm, tm)
    return _PAIRS[key]


def _pool(model, num_pages=32, page_size=4, **kw):
    return KVPagePool.for_model(model, num_pages, page_size=page_size,
                                **kw)


def _prompt(rng, T0):
    return rng.randint(1, VOCAB + 1, (T0,)).astype(np.int32)


def _stream(dec, params, prompt, max_new):
    """The first token and the max_new - 1 that follow, then release."""
    seq = dec.start(params, prompt)
    toks = [seq.last]
    for _ in range(max_new - 1):
        toks.append(dec.step(params, seq))
    seq.release()
    return np.asarray(toks)


# ---------------------------------------------------------------------------
# allocator
# ---------------------------------------------------------------------------

def test_bucket_ladder_doubles_to_max():
    assert page_bucket_ladder(12) == [1, 2, 4, 8, 12]
    assert page_bucket_for(3, 12) == 4
    assert page_bucket_for(12, 12) == 12
    with pytest.raises(PoolExhausted):
        page_bucket_for(13, 12)
    with pytest.raises(ValueError):
        page_bucket_ladder(0)


def test_alloc_free_and_exhaustion_accounting():
    pool = KVPagePool(num_pages=4, layers=1, num_kv_heads=1,
                      page_size=2, head_dim=4, device="cpu")
    a = pool.alloc(3)
    assert pool.free_pages == 1 and pool.high_water == 3
    with pytest.raises(PoolExhausted):
        pool.alloc(2)
    assert pool.exhaustions == 1
    a.extend(1)
    assert pool.free_pages == 0 and pool.high_water == 4
    a.release()
    a.release()                      # idempotent
    assert pool.free_pages == 4
    assert pool.frees == 4 and pool.allocs == 4
    with pytest.raises(RuntimeError, match="released"):
        a.extend(1)
    stats = pool.stats()
    assert stats["occupancy"] == 0.0
    # f32 K + V: 2 * 4 pages * (1 layer * 1 head * 2 slots * 4) * 4 bytes
    assert stats["arena_bytes"] == 256
    assert stats["arena_bytes"] == JaxPool(4, 1, 1, 2, 4).arena_bytes()
    half = KVPagePool(4, 1, 1, 2, 4, dtype=torch.bfloat16, device="cpu")
    assert half.arena_bytes() == 128
    assert pool.arena[0].shape == (4, 1, 1, 2, 4)
    assert pool.arena[0].device.type == "cpu"


def test_owner_budgets_shed_only_the_owner():
    pool = KVPagePool(num_pages=8, layers=1, num_kv_heads=1,
                      page_size=2, head_dim=4, device="cpu")
    pool.set_owner_budget("a", 3)
    la = pool.alloc(2, owner="a")
    with pytest.raises(PoolExhausted, match="budget"):
        pool.alloc(2, owner="a")
    with pytest.raises(PoolExhausted, match="budget"):
        la.extend(2)
    lb = pool.alloc(4, owner="b")            # no budget: the free list
    pool.default_owner = "a"
    lc = pool.alloc(1)                       # charged to the default
    assert pool.owner_held("a") == 3 and pool.owner_held("b") == 4
    assert pool.stats()["by_owner"] == {"a": 3, "b": 4}
    for lease in (la, lb, lc):
        lease.release()
    assert pool.owner_held("a") == 0 and pool.free_pages == 8
    assert pool.exhaustions == 2


def test_pool_on_another_device_than_the_model_raises():
    _, tm = _pair()
    pool = _pool(tm)
    pool.device = torch.device("cuda", 0)    # as a pool on the card says
    with pytest.raises(ValueError, match="device"):
        tgen.PagedDecoder(tm, pool)
    with pytest.raises(ValueError, match="device"):
        InferenceServer(tm, kv_pool=pool)
    with pytest.raises(ValueError, match="geometry"):
        tgen.PagedDecoder(tm, KVPagePool(8, 2, 2, 4, 8, device="cpu"))


# ---------------------------------------------------------------------------
# paged decode == unpaged decode == the JAX package's paged decode
# ---------------------------------------------------------------------------

def test_paged_stream_matches_unpaged_and_jax_paged():
    jm, tm = _pair()
    pool = _pool(tm)
    dec = tgen.cached_paged_decoder(tm, pool)
    jdec = jgen.cached_paged_decoder(jm, JaxPool.for_model(jm, 32,
                                                           page_size=4))
    gen = tgen.cached_generate(tm)
    params, jparams = tm.param_tree(), jm.param_tree()
    rng = np.random.RandomState(0)
    for T0, max_new in ((5, 12), (3, 16)):
        prompt = _prompt(rng, T0)
        got = _stream(dec, params, prompt, max_new)
        unpaged = gen(params, prompt[None], max_new).numpy()[0, T0:]
        want = _stream(jdec, jparams, prompt, max_new)
        np.testing.assert_array_equal(got, unpaged)
        np.testing.assert_array_equal(got, want)
    assert pool.free_pages == pool.num_pages


def test_rope_gqa_paged_stream_matches_unpaged():
    _, tm = _pair(rope=True, num_kv_heads=1, norm="rms", mlp="swiglu")
    pool = _pool(tm)
    dec = tgen.cached_paged_decoder(tm, pool)
    gen = tgen.cached_generate(tm)
    params = tm.param_tree()
    rng = np.random.RandomState(10)
    for T0, max_new in ((5, 12), (3, 16)):
        prompt = _prompt(rng, T0)
        np.testing.assert_array_equal(
            _stream(dec, params, prompt, max_new),
            gen(params, prompt[None], max_new).numpy()[0, T0:])
    assert pool.free_pages == pool.num_pages


def test_interleaved_sequences_do_not_interfere():
    """Two decodes sharing one arena, advanced alternately: each stream
    equals its isolated unpaged reference."""
    _, tm = _pair()
    params = tm.param_tree()
    pool = _pool(tm)
    dec = tgen.cached_paged_decoder(tm, pool)
    gen = tgen.cached_generate(tm)
    rng = np.random.RandomState(1)
    pa, pb = _prompt(rng, 4), _prompt(rng, 6)
    ref_a = gen(params, pa[None], 10).numpy()[0, 4:]
    ref_b = gen(params, pb[None], 10).numpy()[0, 6:]
    sa, sb = dec.start(params, pa), dec.start(params, pb)
    ta, tb = [sa.last], [sb.last]
    for _ in range(9):
        ta.append(dec.step(params, sa))
        tb.append(dec.step(params, sb))
    sa.release()
    sb.release()
    np.testing.assert_array_equal(np.asarray(ta), ref_a)
    np.testing.assert_array_equal(np.asarray(tb), ref_b)
    assert pool.free_pages == pool.num_pages


def test_page_window_covering_arena_matches_dense_exactly():
    """A window wide enough to cover every page a decode can hold is
    exactly the dense paged path."""
    _, tm = _pair()
    params = tm.param_tree()
    pool = _pool(tm)
    dense = tgen.cached_paged_decoder(tm, pool)
    win = tgen.cached_paged_decoder(tm, pool, page_window=8,
                                    page_globals=1)
    rng = np.random.RandomState(8)
    for T0, max_new in ((5, 12), (16, 16)):
        prompt = _prompt(rng, T0)
        np.testing.assert_array_equal(_stream(win, params, prompt, max_new),
                                      _stream(dense, params, prompt,
                                              max_new))
    assert pool.free_pages == pool.num_pages


def test_binding_page_window_matches_jax_through_block_sparse_prefill(
        monkeypatch):
    """Page size 4, prompt 16 (4 pages), window 2 + 1 global: the
    prefill runs the page-window block mask through
    ``block_sparse_attention`` on both sides (K6's plain version here),
    and each decode step gathers the anchor + window pages.  The stream
    equals the JAX package's, and the first token's logits agree."""
    jm, tm = _pair()
    params, jparams = tm.param_tree(), jm.param_tree()
    rng = np.random.RandomState(9)
    prompt = _prompt(rng, 16)
    calls = []
    real = tgen.block_sparse_attention

    def spy(q, k, v, mask, causal=False):
        calls.append((mask.mask.shape, mask.block_q, causal))
        return real(q, k, v, mask, causal=causal)

    monkeypatch.setattr(tgen, "block_sparse_attention", spy)
    pool = _pool(tm)
    win = tgen.cached_paged_decoder(tm, pool, page_window=2,
                                    page_globals=1)
    jwin = jgen.cached_paged_decoder(jm, JaxPool.for_model(jm, 32,
                                                           page_size=4),
                                     page_window=2, page_globals=1)
    got = _stream(win, params, prompt, 12)
    assert calls == [((4, 4), 4, True)]      # one layer, one prefill
    np.testing.assert_array_equal(got, _stream(jwin, jparams, prompt, 12))
    assert pool.free_pages == pool.num_pages

    # the first token's logits: each package's paged windowed prefill
    tprefill, _ = tgen._paged_machinery(tm, 1, 1, 4, page_window=2,
                                        page_globals=1)
    jprefill, _ = jgen._paged_machinery(jm, 1, 1, 4, page_window=2,
                                        page_globals=1)
    shape = (4, 1, 2, 4, 8)
    with torch.no_grad():
        t_logits = tprefill(params, torch.as_tensor(prompt)[None],
                            torch.arange(4), torch.zeros(shape),
                            torch.zeros(shape))
        # the dense paged prefill, which the mask changes
        dprefill, _ = tgen._paged_machinery(tm, 1, 1, 4)
        d_logits = dprefill(params, torch.as_tensor(prompt)[None],
                            torch.arange(4), torch.zeros(shape),
                            torch.zeros(shape))
    j_logits, _, _ = jprefill(jparams, jnp.asarray(prompt)[None],
                              jnp.arange(4), jnp.zeros(shape),
                              jnp.zeros(shape))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=0, atol=1e-4)
    assert not torch.allclose(d_logits, t_logits)


def test_page_table_reuse_keeps_one_shape_per_bucket():
    """A long decode crossing several page buckets dispatches at most
    one decode shape per bucket, and a SECOND sequence replaying the
    same growth adds none."""
    _, tm = _pair()
    params = tm.param_tree()
    pool = _pool(tm, num_pages=32, page_size=2)
    dec = tgen.cached_paged_decoder(tm, pool)
    prompt = _prompt(np.random.RandomState(2), 3)

    def run():
        seq = dec.start(params, prompt)
        for _ in range(24):          # grows through buckets 2, 4, 8, 16
            dec.step(params, seq)
        seq.release()

    run()
    stats = dec.compile_stats()
    buckets_used = {page_bucket_for(n, dec.max_pages)
                    for n in range(2, pool.pages_for_tokens(3 + 25) + 1)}
    assert 1 <= stats["decode_cache_size"] <= len(buckets_used)
    assert stats["prefill_cache_size"] == 1
    run()                            # pure reuse
    assert dec.compile_stats() == stats
    assert pool.free_pages == pool.num_pages


# ---------------------------------------------------------------------------
# the server: lifecycle, no page leaks, typed outcomes
# ---------------------------------------------------------------------------

def _lm_server(model, pool, **kw):
    kw.setdefault("max_batch", 8)
    return InferenceServer(model, kv_pool=pool, **kw)


def _slow_steps(monkeypatch, model, pool, seconds):
    """Every decode step of the server's paged decoder takes at least
    ``seconds`` (the decoder is the one the server looks up)."""
    dec = tgen.cached_paged_decoder(model, pool)
    step = dec.step

    def slow(params, seq):
        time.sleep(seconds)
        return step(params, seq)

    monkeypatch.setattr(dec, "step", slow)


def test_server_paged_stream_matches_unpaged_and_reports_the_pool():
    _, tm = _pair()
    pool = _pool(tm)
    gen = tgen.cached_generate(tm)
    rng = np.random.RandomState(11)
    prompts = [_prompt(rng, 5) for _ in range(3)] + [_prompt(rng, 7)]
    srv = _lm_server(tm, pool).start()
    try:
        futs = [srv.submit_generate(p, 8) for p in prompts]
        res = [f.result(60) for f in futs]
        health = srv.health()
    finally:
        assert srv.stop(10)
    assert [r.status for r in res] == [Status.OK] * 4
    for p, r in zip(prompts, res):
        np.testing.assert_array_equal(
            r.output, gen(tm.param_tree(), p[None], 8).numpy()[0, len(p):])
    assert health["role"] == "both" and health["kv"]["num_pages"] == 32
    snap = srv.metrics.snapshot()
    assert snap["ttft_p50_s"] is not None and snap["kv_pages_total"] == 32
    assert pool.free_pages == pool.num_pages


def test_eos_stop_pads_and_releases_pages():
    _, tm = _pair()
    pool = _pool(tm)
    srv = _lm_server(tm, pool).start()
    try:
        prompt = _prompt(np.random.RandomState(3), 5)
        # the guaranteed eos: the FIRST generated token, then ask for
        # more — everything after must be pad
        probe = srv.submit_generate(prompt, max_new=1).result(60)
        assert probe.ok
        eos = int(probe.output[0])
        res = srv.submit_generate(prompt, max_new=6, eos_id=eos,
                                  pad_id=1).result(60)
        assert res.ok
        np.testing.assert_array_equal(res.output, [eos, 1, 1, 1, 1, 1])
    finally:
        srv.stop(10)
    assert pool.free_pages == pool.num_pages


def test_deadline_expiry_mid_decode_resolves_typed_and_frees(monkeypatch):
    _, tm = _pair()
    pool = _pool(tm)
    _slow_steps(monkeypatch, tm, pool, 0.05)
    srv = _lm_server(tm, pool).start()
    try:
        prompt = _prompt(np.random.RandomState(4), 5)
        res = srv.submit_generate(prompt, max_new=20,
                                  deadline_s=0.3).result(60)
        assert res.status is Status.DEADLINE_EXCEEDED
        assert "mid-decode" in res.error
    finally:
        srv.stop(10)
    assert pool.free_pages == pool.num_pages


def test_hard_stop_mid_decode_cancels_typed_and_frees(monkeypatch):
    _, tm = _pair()
    pool = _pool(tm)
    _slow_steps(monkeypatch, tm, pool, 0.05)
    srv = _lm_server(tm, pool).start()
    prompt = _prompt(np.random.RandomState(5), 5)
    fut = srv.submit_generate(prompt, max_new=26)
    time.sleep(0.3)                  # decode underway
    srv.stop(timeout=30)
    res = fut.result(60)
    assert res.status is Status.CANCELLED
    assert "mid-decode" in res.error
    assert pool.free_pages == pool.num_pages


def test_pool_exhaustion_sheds_typed_and_recovers():
    """A pool too small for the offered concurrency sheds OVERLOADED
    (never a hang, never an admission of an unservable decode) and
    serves again once the survivors drain."""
    _, tm = _pair()
    pool = _pool(tm, num_pages=3, page_size=4)   # one request's worth
    srv = _lm_server(tm, pool, batch_window_s=0.05).start()
    try:
        rng = np.random.RandomState(6)
        prompts = [_prompt(rng, 8) for _ in range(4)]
        res = [f.result(120) for f in
               [srv.submit_generate(p, max_new=4) for p in prompts]]
        statuses = [r.status for r in res]
        assert statuses.count(Status.OK) == 1, statuses
        shed = [r for r in res if r.status is Status.OVERLOADED]
        assert len(shed) == 3
        assert all("KV pool exhausted" in r.error for r in shed)
        assert pool.exhaustions >= 3
        assert pool.free_pages == pool.num_pages
        again = srv.submit_generate(prompts[1], max_new=4).result(60)
        assert again.ok
        assert srv.breaker.state == "closed"
    finally:
        srv.stop(10)
    assert pool.free_pages == pool.num_pages


def test_exhaustion_on_a_page_extension_sheds_mid_decode():
    _, tm = _pair()
    pool = _pool(tm, num_pages=4, page_size=4)
    held = pool.alloc(2)             # another request's pages
    srv = _lm_server(tm, pool).start()
    try:
        prompt = _prompt(np.random.RandomState(12), 7)
        # 7 + 8 tokens need 4 pages; 2 are free
        res = srv.submit_generate(prompt, max_new=8).result(60)
        assert res.status is Status.OVERLOADED
        assert "mid-decode" in res.error
        assert pool.free_pages == 2
    finally:
        srv.stop(10)
    held.release()
    assert pool.free_pages == pool.num_pages


# ---------------------------------------------------------------------------
# prefill / decode roles
# ---------------------------------------------------------------------------

def test_roles_are_validated():
    _, tm = _pair()
    with pytest.raises(ValueError, match="requires a kv_pool"):
        InferenceServer(tm, role="decode")
    with pytest.raises(ValueError, match="not in"):
        InferenceServer(tm, kv_pool=_pool(tm), role="router")
    srv = InferenceServer(tm)
    with pytest.raises(RuntimeError, match="kv_pool"):
        srv.submit_prefill(np.arange(1, 5))
    with pytest.raises(RuntimeError, match="kv_pool"):
        srv.submit_decode(b"", 4)
    assert ROLES == ("prefill", "decode", "both")
    assert serves_phase(None, "decode") and not serves_phase("prefill",
                                                             "decode")
    health = {"a": {"role": "prefill"}, "b": {"role": "decode"},
              "c": {"role": "both", "model": "m"}}
    assert pool_members(health, "decode") == ("b", "c")
    assert pool_members(health, "m:prefill") == ("c",)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_prefill_then_decode_equals_both(dtype):
    """A prefill server seals the prompt's pages and first token; a
    decode server with its own pool continues: the first token plus the
    rest equal the "both" server's stream.  A bf16 arena's pages cross
    as their bit patterns."""
    _, tm = _pair()
    rng = np.random.RandomState(13)
    prompts = [_prompt(rng, 6), _prompt(rng, 9)]
    both_pool = _pool(tm, dtype=dtype)
    pre_pool, dec_pool = _pool(tm, 8, dtype=dtype), _pool(tm, 8, dtype=dtype)
    both = _lm_server(tm, both_pool).start()
    pre = _lm_server(tm, pre_pool, role="prefill").start()
    dec = _lm_server(tm, dec_pool, role="decode").start()
    try:
        want = [both.submit_generate(p, 10).result(60) for p in prompts]
        blobs = [pre.submit_prefill(p).result(60) for p in prompts]
        assert all(b.ok for b in blobs)
        assert pre_pool.free_pages == 8      # released at export
        got = [dec.submit_decode(b.output, 10).result(60) for b in blobs]
        assert pre.health()["role"] == "prefill"
        assert dec.health()["kv"]["free_pages"] == 8
    finally:
        for s in (both, pre, dec):
            s.stop(10)
    for w, b, g in zip(want, blobs, got):
        assert w.ok and g.ok
        first = deserialize_handoff(b.output)["first_token"]
        np.testing.assert_array_equal(np.concatenate([[first], g.output]),
                                      w.output)
        assert ("kv_dtype" in deserialize_handoff(b.output)) == (
            dtype == torch.bfloat16)
    assert all(p.free_pages == p.num_pages
               for p in (both_pool, pre_pool, dec_pool))


def test_decode_refuses_geometry_mismatch_and_corrupt_blob_typed():
    _, tm = _pair()
    pool = _pool(tm, page_size=4)
    pre_pool = _pool(tm, 8)
    pre = _lm_server(tm, pre_pool, role="prefill").start()
    srv = _lm_server(tm, pool, role="decode").start()
    try:
        k = np.zeros((1, 2, 2, 8, 8), np.float32)   # page_size 8
        blob = serialize_handoff(k, k, first_token=1, pos=3, page_size=8)
        res = srv.submit_decode(blob, max_new=4).result(60)
        assert res.status is Status.INTERNAL_ERROR
        assert "geometry" in res.error
        good = pre.submit_prefill(
            _prompt(np.random.RandomState(14), 6)).result(60).output
        bad = bytearray(good)
        bad[len(bad) // 2] ^= 0x40
        res = srv.submit_decode(bytes(bad), max_new=4).result(60)
        assert res.status is Status.INTERNAL_ERROR
        assert "crc32c" in res.error
        assert srv.submit_decode(good, max_new=4).result(60).ok
    finally:
        pre.stop(10)
        srv.stop(10)
    assert pool.free_pages == pool.num_pages
    assert pre_pool.free_pages == pre_pool.num_pages


# ---------------------------------------------------------------------------
# handoff integrity and the wire format
# ---------------------------------------------------------------------------

def test_handoff_roundtrip_and_corruption_refused():
    k = np.arange(2 * 2 * 1 * 4 * 4, dtype=np.float32).reshape(
        2, 2, 1, 4, 4)
    blob = serialize_handoff(k, k + 1, first_token=7, pos=6, page_size=4)
    h = deserialize_handoff(blob)
    assert h["first_token"] == 7 and h["pos"] == 6
    np.testing.assert_array_equal(h["k_pages"], k)
    np.testing.assert_array_equal(h["v_pages"], k + 1)
    bad = bytearray(blob)
    bad[len(bad) // 2] ^= 0x40
    with pytest.raises(HandoffCorrupt, match="crc32c"):
        deserialize_handoff(bytes(bad))
    with pytest.raises(HandoffCorrupt, match="magic"):
        deserialize_handoff(b"XXXX" + blob[4:])
    with pytest.raises(HandoffCorrupt, match="header says"):
        deserialize_handoff(blob[:-3])
    with pytest.raises(HandoffCorrupt, match="truncated"):
        deserialize_handoff(b"short")
    with pytest.raises(HandoffCorrupt, match="bytes"):
        deserialize_handoff("not bytes")
    with pytest.raises(ValueError, match="page_size"):
        serialize_handoff(k, k, first_token=1, pos=1, page_size=8)


def test_f32_handoff_is_the_jax_wire_format_both_ways():
    rng = np.random.RandomState(15)
    k = rng.randn(3, 2, 2, 4, 8).astype(np.float32)
    v = rng.randn(3, 2, 2, 4, 8).astype(np.float32)
    ours = serialize_handoff(k, v, first_token=5, pos=10, page_size=4)
    theirs = jax_serialize(k, v, first_token=5, pos=10, page_size=4)
    assert ours == theirs
    for read, blob in ((deserialize_handoff, theirs),
                       (jax_deserialize, ours)):
        h = read(blob)
        np.testing.assert_array_equal(h["k_pages"], k)
        np.testing.assert_array_equal(h["v_pages"], v)
        assert (h["first_token"], h["pos"], h["page_size"]) == (5, 10, 4)
    # a JAX-sealed blob imports into the port's pool
    pool = KVPagePool(4, 2, 2, 4, 8, device="cpu")
    pool.write_pages([2, 0, 3], jax_deserialize(ours)["k_pages"],
                     deserialize_handoff(theirs)["v_pages"])
    np.testing.assert_array_equal(pool.arena[0][[2, 0, 3]].numpy(), k)
    np.testing.assert_array_equal(pool.read_pages([2, 0, 3])[1], v)


def test_bf16_pages_round_trip_bit_for_bit():
    src = KVPagePool(4, 2, 2, 4, 8, dtype=torch.bfloat16, device="cpu")
    dst = KVPagePool(6, 2, 2, 4, 8, dtype=torch.bfloat16, device="cpu")
    g = torch.Generator().manual_seed(16)
    ak, av = src.arena
    ak.copy_(torch.randn(ak.shape, generator=g).to(torch.bfloat16))
    av.copy_(torch.randn(av.shape, generator=g).to(torch.bfloat16) * 1e30)
    ak[1, 0, 0, 0, 0] = float("nan")
    k_pages, v_pages = src.read_pages([1, 3])
    assert k_pages.dtype == np.uint16 and src.wire_dtype == "bfloat16"
    blob = serialize_handoff(k_pages, v_pages, 1, 8, 4,
                             extras={"kv_dtype": src.wire_dtype})
    h = deserialize_handoff(blob)
    dst.write_pages([5, 0], h["k_pages"], h["v_pages"],
                    wire_dtype=h["kv_dtype"])
    for a, b in zip(src.arena, dst.arena):
        assert torch.equal(a[[1, 3]].view(torch.int16),
                           b[[5, 0]].view(torch.int16))
    with pytest.raises(ValueError, match="uint16"):
        dst.write_pages([1], k_pages[:1].astype(np.float32),
                        v_pages[:1].astype(np.float32), wire_dtype="bfloat16")
    with pytest.raises(ValueError, match="page ids"):
        dst.write_pages([1, 2, 3], k_pages, v_pages, wire_dtype="bfloat16")


def test_crc32c_matches_the_jax_package():
    rng = np.random.RandomState(17)
    for n in (0, 1, 7, 64, 1000):
        data = rng.randint(0, 256, n).astype(np.uint8).tobytes()
        assert crc32c(data) == jax_crc32c(data)
        assert masked_crc32c(data) == jax_masked(data)
    assert crc32c(b"123456789") == 0xE3069283     # the CRC-32C check value
