"""The port's serving slice end to end against the JAX package, in f32
on the CPU: a small TransformerLM's forward, its greedy decode and the
port's InferenceServer, with weights carried across by
``interop.jax_params.load_param_tree``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.models.generate import cached_generate as jax_cached_generate
from bigdl_tpu.models.generate import make_generate as jax_make_generate
from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu_torch.interop import load_param_tree, param_tree_numpy
from bigdl_tpu_torch.models.generate import make_generate
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.serving import InferenceServer, Status

# The suite runs in several processes at once: one intra-op thread each
# keeps these small tensors from crowding the timing-sensitive tests.
torch.set_num_threads(1)

CFG = dict(embed_dim=64, num_heads=4, num_layers=2, max_len=64)
V = 64


def _pair(**kw):
    jm = JaxLM(V, **CFG, **kw)
    tm = TransformerLM(V, **CFG, **kw, device="cpu")
    load_param_tree(tm, jax.tree_util.tree_map(np.asarray, jm.param_tree()))
    jm.evaluate()
    tm.evaluate()
    return jm, tm


def _prompts(B, T, seed):
    return np.random.RandomState(seed).randint(
        1, V + 1, size=(B, T)).astype(np.int32)


@pytest.mark.parametrize("kw", [dict(seq_strategy="flash"),
                                dict(seq_strategy="dense"),
                                dict(norm="rms", mlp="swiglu", rope=True,
                                     num_kv_heads=2)],
                         ids=["flash", "dense", "llama"])
def test_full_sequence_log_probs_match(kw):
    jm, tm = _pair(**kw)
    ids = _prompts(3, 20, seed=0)
    want = np.asarray(jm.forward(jnp.asarray(ids)))
    with torch.no_grad():
        got = tm(torch.as_tensor(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("kw", [dict(seq_strategy="flash"),
                                dict(norm="rms", mlp="swiglu", rope=True,
                                     num_kv_heads=2)],
                         ids=["gpt2", "llama"])
def test_greedy_decode_token_exact(kw):
    jm, tm = _pair(**kw)
    T0, max_new = 12, 16
    prompts = _prompts(3, T0, seed=1)
    want = np.asarray(jax_make_generate(jm)(jm.param_tree(), prompts,
                                            max_new))
    got = make_generate(tm)(tm.param_tree(), prompts, max_new).numpy()
    # a near-tie could flip argmax on rounding alone: require a clear
    # top-2 margin at every generated position (teacher forcing)
    with torch.no_grad():
        lp = tm(torch.as_tensor(got[:, :-1])).numpy()
    top2 = np.sort(lp[:, T0 - 1:], axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 1e-3
    np.testing.assert_array_equal(got, want)


def test_greedy_decode_eos_pad_matches():
    jm, tm = _pair(seq_strategy="flash")
    prompts = _prompts(2, 8, seed=2)
    free = np.asarray(jax_make_generate(jm)(jm.param_tree(), prompts, 10))
    eos = int(free[0, 10])   # row 0 emits it at its third generated step
    kw = dict(eos_id=eos, pad_id=V)
    want = np.asarray(jax_make_generate(jm)(jm.param_tree(), prompts, 10,
                                            **kw))
    got = make_generate(tm)(tm.param_tree(), prompts, 10, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0, 11:] == V).all()


def test_sampled_decode_is_seeded_and_in_vocab():
    _, tm = _pair(seq_strategy="flash")
    gen = make_generate(tm)
    prompts = _prompts(2, 8, seed=3)

    def run(seed):
        return gen(tm.param_tree(), prompts, 12,
                   generator=torch.Generator().manual_seed(seed),
                   temperature=0.8, top_k=10, top_p=0.9).numpy()

    a, b = run(5), run(5)
    np.testing.assert_array_equal(a, b)
    assert a.min() >= 1 and a.max() <= V
    with pytest.raises(ValueError, match="Generator"):
        gen(tm.param_tree(), prompts, 4, temperature=0.8)


def test_inference_server_matches_jax():
    jm, tm = _pair(seq_strategy="flash")
    prompts = _prompts(3, 10, seed=4)
    features = _prompts(2, 16, seed=5)
    server = InferenceServer(tm, max_batch=4).start()
    try:
        gen_futs = [server.submit_generate(p, 8) for p in prompts]
        cls_futs = [server.submit(f) for f in features]
        gen_res = [f.result(timeout=120) for f in gen_futs]
        cls_res = [f.result(timeout=120) for f in cls_futs]
    finally:
        assert server.stop(timeout=30)
    assert [r.status for r in gen_res + cls_res] == [Status.OK] * 5
    want = np.asarray(jax_cached_generate(jm)(jm.param_tree(), prompts,
                                              8))[:, 10:]
    np.testing.assert_array_equal(np.stack([r.output for r in gen_res]),
                                  want)
    want_lp = np.asarray(jm.forward(jnp.asarray(features)))
    np.testing.assert_allclose(np.stack([r.output for r in cls_res]),
                               want_lp, rtol=0, atol=1e-4)
    assert server.metrics.counts["ok"] == 5


def test_inference_server_refuses_unported_paths():
    """Only a device mesh is still refused; tracing and tenants are
    ported (a malformed trace context degrades to untraced)."""
    _, tm = _pair()
    with pytest.raises(NotImplementedError, match="mesh"):
        InferenceServer(tm, mesh=object())
    server = InferenceServer(tm, trace_sink=None, model_name="m",
                             max_batch=2).start()
    try:
        res = server.submit_generate(np.arange(1, 5), 2,
                                     trace=object()).result(timeout=120)
    finally:
        assert server.stop(timeout=30)
    assert res.status is Status.OK and res.trace_id is None
    assert server.health()["model"] == "m"


def test_load_param_tree_round_trip_and_errors():
    jm, tm = _pair()
    tree = jax.tree_util.tree_map(np.asarray, jm.param_tree())
    back = param_tree_numpy(tm)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    # state_dict keys are the JAX tree paths joined with dots
    assert "1.1.wq" in tm.state_dict() and "pos" in tm.state_dict()
    assert tm.buffer_tree() == jm.buffer_tree()

    missing = dict(tree)
    del missing["pos"]
    with pytest.raises(KeyError, match="pos"):
        load_param_tree(tm, missing)
    extra = dict(tree, bogus=np.zeros(3, np.float32))
    with pytest.raises(KeyError, match="bogus"):
        load_param_tree(tm, extra)
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    bad["1"]["1"]["wq"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match=r"1\.1\.wq"):
        load_param_tree(tm, bad)
