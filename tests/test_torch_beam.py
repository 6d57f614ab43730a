"""The port's beam search and int8 KV cache against the JAX package, in
f32 on the CPU (``models/generate.py``: ``make_beam_search``,
``make_generate(kv_dtype="int8")``).  Weights cross with
``interop.load_param_tree``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn  # noqa: F401 — registry
from bigdl_tpu.models.generate import make_beam_search as jax_beam
from bigdl_tpu.models.generate import make_generate as jax_generate
from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.utils.rng import RNG as JRNG
from bigdl_tpu_torch.interop import load_param_tree
from bigdl_tpu_torch.models import generate as tgen
from bigdl_tpu_torch.models.transformer import TransformerLM

# The suite runs in several processes at once: one intra-op thread each
torch.set_num_threads(1)


def _pair(vocab, seed, **cfg):
    JRNG().set_seed(seed)
    jm = JaxLM(vocab, **cfg)
    tm = TransformerLM(vocab, **cfg, device="cpu")
    load_param_tree(tm, jax.tree_util.tree_map(np.asarray, jm.param_tree()))
    jm.evaluate()
    tm.evaluate()
    return jm, tm


def _oracle_pair():
    """``tests/test_generate.py``'s exhaustive-oracle model: V 7."""
    return _pair(7, 9, embed_dim=12, num_heads=2, mlp_dim=24, num_layers=2,
                 max_len=8)


def _small_pair():
    """``tests/test_generate.py``'s seeded model: V 23, 2 layers."""
    return _pair(23, 4, embed_dim=16, num_heads=2, mlp_dim=32, num_layers=2,
                 max_len=24)


@pytest.mark.parametrize("with_eos", [False, True], ids=["free", "eos"])
def test_exhaustive_beam_equals_jax(with_eos):
    """num_beams = V^2 holds every prefix of 3 tokens (the search is
    exhaustive): the surplus first-step beams start dead at -inf and
    are claimed by real expansions at the next depth."""
    jm, tm = _oracle_pair()
    prompt = np.array([[2, 5]], np.int32)
    kw = {}
    if with_eos:
        # an eos that competes: the 2nd-best first token
        lp = np.asarray(jm.forward(jnp.asarray(prompt)))[0, -1]
        kw = dict(eos_id=int(np.argsort(lp)[-2]) + 1, pad_id=1)
    want_ids, want_sc = jax_beam(jm)(jm.param_tree(), prompt, max_new=3,
                                     num_beams=49, **kw)
    ids, sc = tgen.make_beam_search(tm)(tm.param_tree(), prompt, max_new=3,
                                        num_beams=49, **kw)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(sc.numpy(), np.asarray(want_sc), rtol=0,
                               atol=1e-4)
    assert ids.dtype == torch.int32 and sc.dtype == torch.float32


def test_top_k_breaks_ties_as_lax_top_k():
    """Lower index first among equal values (``torch.topk`` and an
    unstable sort order them otherwise on rows like these), -inf
    included."""
    x = np.random.RandomState(0).randint(0, 4, (3, 2000)).astype(np.float32)
    x[:, ::7] = -np.inf
    for k in (1, 64, 2000):
        want_v, want_i = jax.lax.top_k(x, k)
        v, i = tgen._top_k(torch.as_tensor(x), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("with_eos", [False, True], ids=["free", "eos"])
def test_tied_tokens_beam_equals_jax(with_eos):
    """Two vocabulary rows of the head made equal: every expansion ties
    their candidates exactly, so which beam survives and which is
    returned is the tie order's."""
    jm, tm = _oracle_pair()
    params = jax.tree_util.tree_map(np.asarray, jm.param_tree())
    head = params[str(len(params) - 2)]
    for name in head:
        head[name] = head[name].copy()
        head[name][5] = head[name][2]           # id 6 ties id 3
    load_param_tree(tm, params)
    prompt = np.array([[2, 5]], np.int32)
    kw = dict(eos_id=3, pad_id=1) if with_eos else {}
    want_ids, want_sc = jax_beam(jm)(params, prompt, max_new=4,
                                     num_beams=6, **kw)
    ids, sc = tgen.make_beam_search(tm)(tm.param_tree(), prompt, max_new=4,
                                        num_beams=6, **kw)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(sc.numpy(), np.asarray(want_sc), rtol=0,
                               atol=1e-4)


def test_four_beams_on_a_small_lm_equal_jax():
    jm, tm = _small_pair()
    prompt = np.random.RandomState(6).randint(1, 24, (2, 4)).astype(np.int32)
    want_ids, want_sc = jax_beam(jm)(jm.param_tree(), prompt, max_new=6,
                                     num_beams=4)
    ids, sc = tgen.make_beam_search(tm)(tm.param_tree(), prompt, max_new=6,
                                        num_beams=4)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(sc.numpy(), np.asarray(want_sc), rtol=0,
                               atol=1e-4)
    # the score is the sum of the returned ids' log-probs
    with torch.no_grad():
        lp = tm(torch.as_tensor(ids.numpy()[:, :-1]))
    picked = torch.gather(lp[:, 3:], -1, ids[:, 4:, None].long() - 1)
    np.testing.assert_allclose(picked.sum(dim=(1, 2)).numpy(), sc.numpy(),
                               rtol=1e-5)


@pytest.mark.parametrize("with_eos", [False, True], ids=["free", "eos"])
def test_one_beam_equals_greedy(with_eos):
    _, tm = _small_pair()
    params = tm.param_tree()
    prompt = np.random.RandomState(14).randint(1, 24, (2, 4)).astype(
        np.int32)
    gen = tgen.make_generate(tm)
    kw = {}
    if with_eos:
        # row 0 emits it at its third generated step
        kw = dict(eos_id=int(gen(params, prompt, 6).numpy()[0, 6]), pad_id=2)
    greedy = gen(params, prompt, 6, **kw).numpy()
    ids, _ = tgen.make_beam_search(tm)(params, prompt, max_new=6,
                                       num_beams=1, **kw)
    np.testing.assert_array_equal(ids.numpy(), greedy)
    if with_eos:
        assert (greedy[0, 7:] == 2).all()


def test_beam_search_validates():
    _, tm = _small_pair()
    beam = tgen.make_beam_search(tm)
    with pytest.raises(ValueError, match="num_beams"):
        beam(tm.param_tree(), np.ones((1, 3), np.int32), 2, num_beams=0)
    with pytest.raises(ValueError, match="max_len"):
        beam(tm.param_tree(), np.ones((1, 20), np.int32), 10)
    with pytest.raises(ValueError, match="positional table"):
        tgen.make_beam_search(tm, max_len=25)
    with pytest.raises(ValueError, match="kv_dtype"):
        tgen.make_beam_search(tm, kv_dtype="int4")


def test_int8_kv_cache_stream_equals_jax():
    """kv_dtype="int8": the prefill attends the full-precision k/v, so
    the first generated token is the full cache's; the later steps read
    the quantized cache.  The stream equals the JAX package's int8
    stream, and so does beam search over the int8 cache."""
    jm, tm = _small_pair()
    prompt = np.random.RandomState(21).randint(1, 24, (2, 5)).astype(
        np.int32)
    params = tm.param_tree()
    q8 = tgen.make_generate(tm, kv_dtype="int8")(params, prompt, 7).numpy()
    full = tgen.make_generate(tm)(params, prompt, 7).numpy()
    want = np.asarray(jax_generate(jm, kv_dtype="int8")(jm.param_tree(),
                                                        prompt, 7))
    np.testing.assert_array_equal(q8, want)
    np.testing.assert_array_equal(q8[:, :6], full[:, :6])
    assert q8.min() >= 1 and q8.max() <= 23
    ids, sc = tgen.make_beam_search(tm, kv_dtype="int8")(params, prompt, 5,
                                                         num_beams=3)
    want_ids, want_sc = jax_beam(jm, kv_dtype="int8")(jm.param_tree(),
                                                      prompt, 5, num_beams=3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(sc.numpy(), np.asarray(want_sc), rtol=0,
                               atol=1e-4)
    with pytest.raises(ValueError, match="kv_dtype"):
        tgen.make_generate(tm, kv_dtype="int4")


def test_int8_quantization_equals_jax_on_the_same_k():
    """The port's absmax quantization against the JAX function's
    arithmetic (``generate.py``'s ``_quant``: f32 absmax over the head
    dim / 127 + 1e-12, ``jnp.round``, which rounds half to even) on the
    same k, with exact halves among the inputs."""
    x = np.random.RandomState(1).randn(2, 2, 8, 16).astype(np.float32)
    x[0, 0, 0, :4] = [127.0, 0.5, 1.5, -2.5]    # scale 1 + 1e-12: halves
    xf = jnp.asarray(x)
    s = jnp.max(jnp.abs(xf), axis=-1, keepdims=True) / 127.0 + 1e-12
    want_q = np.asarray(jnp.round(xf / s).astype(jnp.int8))
    q, sc = tgen._quant_kv(torch.as_tensor(x))
    np.testing.assert_array_equal(q.numpy(), want_q)
    np.testing.assert_allclose(sc.numpy(), np.asarray(s), rtol=1e-6)
    assert q.dtype == torch.int8 and sc.shape == (2, 2, 8, 1)
    assert list(q.numpy()[0, 0, 0, :4]) == [127, 0, 2, -2]
    # dequantized within half a step of the value
    np.testing.assert_allclose((q.float() * sc).numpy(), x,
                               atol=float((sc / 2 + 1e-6).max()))
    # bf16 k quantizes from its f32 value
    q16, s16 = tgen._quant_kv(torch.as_tensor(x).to(torch.bfloat16))
    q32, s32 = tgen._quant_kv(torch.as_tensor(x).to(torch.bfloat16).float())
    assert torch.equal(q16, q32) and torch.equal(s16, s32)
