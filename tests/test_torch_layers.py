"""The port's layers (bigdl_tpu_torch.nn) against the JAX package's, in
f32 on the CPU, after carrying the weights across with
``interop.jax_params.load_param_tree``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as jnn
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.interop import load_param_tree

# The suite runs in several processes at once: one intra-op thread each
# keeps these small tensors from crowding the timing-sensitive tests.
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)


def _numpy_tree(jax_module):
    return jax.tree_util.tree_map(np.asarray, jax_module.param_tree())


def _pair(jax_module, port_module, x):
    """Both modules' eval outputs on the same numpy input."""
    load_param_tree(port_module, _numpy_tree(jax_module))
    jax_module.evaluate()
    want = np.asarray(jax_module.forward(jnp.asarray(x)))
    with torch.no_grad():
        got = port_module.evaluate()(torch.as_tensor(x)).numpy()
    return got, want


def test_linear():
    x = np.random.RandomState(0).randn(2, 5, 12).astype(np.float32)
    got, want = _pair(jnn.Linear(12, 7), tnn.Linear(12, 7, device="cpu"), x)
    np.testing.assert_allclose(got, want, **TOL)
    got, want = _pair(jnn.Linear(12, 7, with_bias=False),
                      tnn.Linear(12, 7, with_bias=False, device="cpu"), x)
    np.testing.assert_allclose(got, want, **TOL)


def test_lookup_table_one_based_ids_and_clamp():
    # 1-based ids; 0 and n_index+3 lie outside and clamp to rows 1 / n
    ids = np.array([[1, 2, 10], [0, 13, 5]], np.int32)
    got, want = _pair(jnn.LookupTable(10, 6),
                      tnn.LookupTable(10, 6, device="cpu"), ids)
    np.testing.assert_array_equal(got, want)
    w = np.asarray(jnn.LookupTable(10, 6).param_tree()["weight"])
    port = tnn.LookupTable(10, 6, device="cpu")
    load_param_tree(port, {"weight": w})
    out = port(torch.as_tensor(ids)).detach().numpy()
    np.testing.assert_array_equal(out[0, 0], w[0])
    np.testing.assert_array_equal(out[1, 0], w[0])     # 0 -> row 1
    np.testing.assert_array_equal(out[1, 1], w[9])     # 13 -> row 10


def test_layer_norm():
    rng = np.random.RandomState(1)
    x = (rng.randn(3, 4, 32) * 3 + 1).astype(np.float32)
    jm = jnn.LayerNorm(32)
    jm.set_param_tree({
        "weight": jnp.asarray(1 + 0.1 * rng.randn(32), jnp.float32),
        "bias": jnp.asarray(0.1 * rng.randn(32), jnp.float32)})
    got, want = _pair(jm, tnn.LayerNorm(32, device="cpu"), x)
    np.testing.assert_allclose(got, want, **TOL)


def test_rms_norm():
    rng = np.random.RandomState(2)
    x = (rng.randn(3, 4, 32) * 3).astype(np.float32)
    jm = jnn.RMSNorm(32)
    jm.set_param_tree({
        "weight": jnp.asarray(1 + 0.1 * rng.randn(32), jnp.float32)})
    got, want = _pair(jm, tnn.RMSNorm(32, device="cpu"), x)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("strategy", ["dense", "flash", "blocksparse"])
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("kv_heads", [None, 2])
def test_multi_head_attention(strategy, rope, kv_heads):
    x = np.random.RandomState(3).randn(2, 24, 32).astype(np.float32)
    kw = dict(causal=True, seq_strategy=strategy, num_kv_heads=kv_heads,
              rope=rope)
    got, want = _pair(jnn.MultiHeadAttention(32, 4, **kw),
                      tnn.MultiHeadAttention(32, 4, device="cpu", **kw), x)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("strategy", ["flash", "blocksparse"])
def test_multi_head_attention_hands_the_op_head_strided_views(strategy,
                                                              monkeypatch):
    """The layer hands the attention op q, k and v as the (B, T, H, D)
    .transpose(1, 2) views of its projections, with no copy (the kernels
    read them in place on the card), and the layer's output and its
    gradient with respect to x match the JAX layer on the same
    transferred parameters."""
    from bigdl_tpu_torch.nn import attention as tattn

    seen = []
    name = "flash_attention" if strategy == "flash" else \
        "block_sparse_attention"
    op = getattr(tattn, name)

    def spy(q, k, v, *args, **kw):
        seen.append([t.stride() for t in (q, k, v)])
        return op(q, k, v, *args, **kw)

    monkeypatch.setattr(tattn, name, spy)
    B, T, E, H = 2, 24, 32, 4
    x = np.random.RandomState(4).randn(B, T, E).astype(np.float32)
    w = np.random.RandomState(5).randn(B, T, E).astype(np.float32)
    kw = dict(causal=True, seq_strategy=strategy)
    jm = jnn.MultiHeadAttention(E, H, **kw)
    tm = tnn.MultiHeadAttention(E, H, device="cpu", **kw)
    got, want = _pair(jm, tm, x)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    D = E // H
    assert seen == [[(T * E, D, E, 1)] * 3]
    want_dx = jax.grad(lambda a: jnp.sum(jm.forward(a) * jnp.asarray(w)))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (dx,) = torch.autograd.grad(tm.evaluate()(xt), xt, torch.from_numpy(w))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), rtol=1e-4,
                               atol=1e-4)


def test_unported_strategies_raise():
    with pytest.raises(NotImplementedError):
        tnn.MultiHeadAttention(32, 4, seq_strategy="ring", device="cpu")
    with pytest.raises(ValueError):
        tnn.MultiHeadAttention(32, 4, seq_strategy="nope", device="cpu")
