"""Block remat and the ``"block"`` attention strategy on the port against
the JAX package, on the CPU.

* ``remat=True``: the loss and every gradient equal the plain model's
  (atol 1e-6, as ``tests/test_transformer_spmd.py:101`` holds the JAX
  remat) and the JAX remat model's (``TOL``); under dropout the
  recompute draws the forward's masks, so the gradients equal the plain
  model's bit for bit; without gradients each block runs once.
* ``blockwise_attention`` against the JAX function on a ragged Tk,
  causal and not, at blocks 4, 7 and larger than T, forward and
  gradients; a ``"block"`` TransformerLM's 6-iteration trajectory
  against the JAX one.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.dataset.dataset import array as jarray
from bigdl_tpu.models.transformer import TransformerLM as JTransformerLM
from bigdl_tpu.utils.rng import RNG as JRNG
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.dataset import Sample, array
from bigdl_tpu_torch.interop import load_param_tree
from bigdl_tpu_torch.interop.jax_params import param_tree_numpy
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.nn import attention as tattn
from bigdl_tpu_torch.nn.module import rng_scope
from bigdl_tpu_torch.parallel import ring_attention as tra
from bigdl_tpu_torch.utils.rng import RNG
from bigdl_tpu_torch.utils.tree import tree_leaves, tree_map

# bigdl_tpu.parallel exports a function of the module's name
jra = importlib.import_module("bigdl_tpu.parallel.ring_attention")

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
TRAJ_RTOL = 2e-3
V, T_LEN, BATCH = 32, 16, 2
KW = dict(embed_dim=16, num_heads=2, num_layers=2, max_len=T_LEN)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ids(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(1, V + 1, (BATCH, T_LEN)).astype(np.int32),
            rng.randint(1, V + 1, (BATCH, T_LEN)).astype(np.int32))


def _port_loss_grads(model, x, y, seed=5):
    model.train()
    params = model.param_tree()
    leaves = tree_leaves(params)
    crit = tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion(), True)
    with rng_scope(torch.Generator().manual_seed(seed)):
        loss = crit._loss(model.apply_fn(params, torch.from_numpy(x)),
                          torch.from_numpy(y))
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads


def _port_pair(dropout=0.0, **kw):
    return [TransformerLM(V, **KW, dropout=dropout, remat=remat, **kw,
                          device="cpu",
                          generator=torch.Generator().manual_seed(3))
            for remat in (False, True)]


def test_remat_equals_plain_and_the_jax_remat():
    x, y = _ids()
    plain, remat = _port_pair()
    jremat = JTransformerLM(V, **KW, remat=True)
    for m in (plain, remat):
        load_param_tree(m, _np(jremat.param_tree()))
    lp, gp = _port_loss_grads(plain, x, y)
    lr, gr = _port_loss_grads(remat, x, y)
    torch.testing.assert_close(lr, lp, rtol=0, atol=1e-6)
    for a, b in zip(gr, gp):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)

    crit = jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion(), True)

    def jloss(p):
        out, _ = jremat.apply_fn(p, jremat.buffer_tree(), jnp.asarray(x),
                                 True, None)
        return crit._loss(out, jnp.asarray(y))

    want, want_g = jax.value_and_grad(jloss)(jremat.param_tree())
    np.testing.assert_allclose(float(lr), float(want), **TOL)
    got_g = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        np.asarray, _as_tree(remat, gr)))
    for a, b in zip(got_g, jax.tree_util.tree_leaves(_np(want_g))):
        np.testing.assert_allclose(a, b, **TOL)


def _as_tree(model, grads):
    """``grads`` (in ``param_tree`` leaf order) as numpy in its layout."""
    it = iter(g.numpy() for g in grads)
    return tree_map(lambda _: next(it), model.param_tree())


def test_remat_under_dropout_recomputes_the_forwards_masks():
    """dropout 0.1: the step generator's state is saved before each
    block and restored for its recompute, so the recomputed masks are
    the forward's: the gradients equal the plain model's bit for bit
    (a recompute drawing new masks would not)."""
    x, y = _ids(1)
    plain, remat = _port_pair(dropout=0.1)
    lp, gp = _port_loss_grads(plain, x, y)
    lr, gr = _port_loss_grads(remat, x, y)
    assert torch.equal(lr, lp)
    for a, b in zip(gr, gp):
        assert torch.equal(a, b)
    # and the masks were live: another step seed gives another loss
    lo, _ = _port_loss_grads(remat, x, y, seed=6)
    assert not torch.equal(lo, lr)


def test_remat_with_a_backward_on_another_thread():
    """The recompute runs where autograd runs the backward, which need
    not be the forward's thread: it reopens the forward's generator
    scope itself."""
    import threading

    x, y = _ids(2)
    plain, remat = _port_pair(dropout=0.1)
    lp, gp = _port_loss_grads(plain, x, y)
    params = remat.param_tree()
    leaves = tree_leaves(params)
    crit = tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion(), True)
    remat.train()
    with rng_scope(torch.Generator().manual_seed(5)):
        loss = crit._loss(remat.apply_fn(params, torch.from_numpy(x)),
                          torch.from_numpy(y))
    out = {}
    th = threading.Thread(target=lambda: out.setdefault(
        "g", torch.autograd.grad(loss, leaves)))
    th.start()
    th.join()
    for a, b in zip(out["g"], gp):
        assert torch.equal(a, b)


def test_remat_runs_each_block_once_without_gradients(monkeypatch):
    """Under no_grad (eval, generate, validation) remat costs nothing:
    one attention a layer; with gradients each block's forward runs
    again in the backward."""
    calls = []
    real = tattn.MultiHeadAttention._attend
    monkeypatch.setattr(tattn.MultiHeadAttention, "_attend",
                        lambda self, q, k, v: calls.append(1) or
                        real(self, q, k, v))
    _, remat = _port_pair()
    x, y = _ids()
    with torch.no_grad():
        remat.evaluate()(torch.from_numpy(x))
    assert len(calls) == KW["num_layers"]
    calls.clear()
    _port_loss_grads(remat, x, y)
    assert len(calls) == 2 * KW["num_layers"]


def test_remat_trains_like_plain_through_local_optimizer():
    x, y = _ids(3)
    out = []
    for m in _port_pair(dropout=0.1):
        opt = toptim.LocalOptimizer(
            m, array([Sample(a, b) for a, b in zip(x, y)]),
            tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion(), True),
            batch_size=BATCH)
        opt.set_optim_method(toptim.SGD(0.1, momentum=0.9))
        opt.set_end_when(toptim.max_iteration(4))
        RNG().set_seed(1)
        opt.optimize()
        out.append([p.detach().clone() for p in m.parameters()])
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_moe_still_raises():
    with pytest.raises(NotImplementedError):
        TransformerLM(V, **KW, moe_experts=2, remat=True, device="cpu")


# ----------------------------------------------------------------------
# blockwise attention
# ----------------------------------------------------------------------

@pytest.mark.parametrize("block", [4, 7, 64])
@pytest.mark.parametrize("causal", [False, True])
def test_blockwise_attention_matches_jax(block, causal):
    """Tq 13, ragged Tk 19 (padded to whole blocks, the pad masked),
    forward and the gradients of q, k and v."""
    rng = np.random.RandomState(block + causal)
    q = rng.randn(2, 3, 13, 8).astype(np.float32)
    k = rng.randn(2, 3, 19, 8).astype(np.float32)
    v = rng.randn(2, 3, 19, 8).astype(np.float32)
    g = rng.randn(2, 3, 13, 8).astype(np.float32)

    def jf(q_, k_, v_):
        return jra.blockwise_attention(q_, k_, v_, block_size=block,
                                       causal=causal)

    want, vjp = jax.vjp(jf, *map(jnp.asarray, (q, k, v)))
    want_g = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = tra.blockwise_attention(tq, tk, tv, block_size=block,
                                  causal=causal)
    got_g = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # and the dense oracle (same Tq and Tk: the causal mask top-left)
    dense = tra.attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(got.detach().numpy(),
                               dense.detach().numpy(), **TOL)


def test_blockwise_attention_bf16_matches_jax():
    """bf16 inputs: scores and P.V summed in f32, P cast to bf16 for P.V,
    the output cast back, as the JAX function."""
    rng = np.random.RandomState(0)
    a = [rng.randn(1, 2, 24, 16).astype(np.float32) for _ in range(3)]
    want = jra.blockwise_attention(*(jnp.asarray(t, jnp.bfloat16)
                                     for t in a), block_size=8, causal=True)
    got = tra.blockwise_attention(*(torch.from_numpy(t).bfloat16()
                                    for t in a), block_size=8, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


def test_block_strategy_layer_matches_jax():
    jm = jnn.MultiHeadAttention(16, 2, causal=True, seq_strategy="block")
    tm = tnn.MultiHeadAttention(16, 2, causal=True, seq_strategy="block",
                                device="cpu")
    assert tm.block_size == jm.block_size == 512
    jm.block_size = tm.block_size = 5
    load_param_tree(tm, _np(jm.param_tree()))
    x = np.random.RandomState(1).randn(2, 12, 16).astype(np.float32)
    want, _ = jm.apply_fn(jm.param_tree(), jm.buffer_tree(), jnp.asarray(x),
                          False, None)
    got = tm.apply_fn(tm.param_tree(), torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_block_strategy_trajectory_matches_jax():
    """Six LocalOptimizer iterations of a "block" TransformerLM (blocks of
    4 over T 16) against the JAX one, from the same weights."""
    rng = np.random.RandomState(0)
    x = rng.randint(1, V + 1, size=(8, T_LEN)).astype(np.int32)
    y = rng.randint(1, V + 1, size=(8, T_LEN)).astype(np.int32)
    kw = dict(KW, seq_strategy="block", output="logits")
    jm = JTransformerLM(V, **kw)
    tm = TransformerLM(V, **kw, device="cpu")
    for blk in tm.blocks:
        blk[1].block_size = 4
    for blk in jm.modules[1:-2]:
        blk.modules[1].block_size = 4
    load_param_tree(tm, _np(jm.param_tree()))
    losses = []
    for m, pkg, ds, crit, R in (
            (jm, joptim, jarray([JSample(a, b) for a, b in zip(x, y)]),
             jnn.TimeDistributedCriterion(jnn.CrossEntropyCriterion(), True),
             JRNG),
            (tm, toptim, array([Sample(a, b) for a, b in zip(x, y)]),
             tnn.TimeDistributedCriterion(tnn.CrossEntropyCriterion(), True),
             RNG)):
        seen = []

        def check(state, _s=seen, _pkg=pkg):
            if "loss" in state:
                _s.append(state["loss"])
            return _pkg.max_iteration(6)(state)

        opt = pkg.LocalOptimizer(m, ds, crit, batch_size=4)
        opt.set_optim_method(pkg.SGD(0.05, momentum=0.9))
        opt.set_end_when(pkg.Trigger(check))
        R().set_seed(1)
        opt.optimize()
        losses.append(seen)
    assert len(losses[1]) == 6
    np.testing.assert_allclose(losses[1], losses[0], rtol=TRAJ_RTOL)
    want = jax.tree_util.tree_flatten_with_path(_np(jm.param_tree()))[0]
    got = jax.tree_util.tree_leaves(param_tree_numpy(tm))
    for (path, w), g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=TRAJ_RTOL, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


def test_ring_and_ulysses_still_raise():
    for strategy in ("ring", "ulysses"):
        with pytest.raises(NotImplementedError):
            TransformerLM(V, **KW, seq_strategy=strategy, device="cpu")
