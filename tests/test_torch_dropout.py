"""Dropout on the port: the ``Dropout`` layer and the transformer's
residual dropout, in f32 on the CPU.

The two packages draw their masks from different generators, so a
training-mode forward is held to its own properties — the keep share,
the scale of the kept entries, the backward's use of the forward's mask,
one generator seed giving one set of bits — and the eval forward, which
draws nothing, to the JAX package's (``TOL``) and to a ``dropout=0``
model's (bit for bit).  A run resumed from its step-4 checkpoint is bit
for bit the uninterrupted run: the step generator is seeded from the
host stream, which the checkpoint's trainState carries.
"""
import math

import numpy as np
import pytest
import torch

import jax

from bigdl_tpu import nn as jnn
from bigdl_tpu.models.transformer import TransformerLM as JTransformerLM
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.dataset import Sample, array
from bigdl_tpu_torch.interop import load_param_tree
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.optim import SGD, LocalOptimizer, several_iteration
from bigdl_tpu_torch.optim.trigger import max_iteration
from bigdl_tpu_torch.utils.rng import RNG

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
V, T_LEN, BATCH = 40, 8, 4
LM_KW = dict(embed_dim=16, num_heads=2, num_layers=2, max_len=T_LEN,
             output="logits")


def _lm(dropout, seed=0):
    return TransformerLM(V, **LM_KW, dropout=dropout, device="cpu",
                         generator=torch.Generator().manual_seed(seed))


def _ids(seed=0):
    rng = np.random.RandomState(seed)
    return torch.as_tensor(rng.randint(1, V + 1, size=(BATCH, T_LEN)))


def test_dropout_layer_mask_scale_and_eval():
    m = tnn.Dropout(0.5, device="cpu")
    x = torch.ones(64, 64)
    with tnn.rng_scope(torch.Generator().manual_seed(0)):
        y = m.forward(x)
    kept = y != 0
    assert 0.4 < float(kept.float().mean()) < 0.6
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 2.0))
    assert torch.equal(m.evaluate().forward(x), x)
    y = tnn.Dropout(0.5, scale=False, device="cpu").forward(x)
    assert set(torch.unique(y).tolist()) == {0.0, 1.0}


@pytest.mark.parametrize("path", ["graph", "replay"])
def test_backward_uses_the_forward_mask(path):
    """``tests/test_layers_oracle.py::test_dropout_mask_consistency``: the
    input gradient is zero exactly where the output is.  ``graph``: the
    forward's own graph (a layer in front with a parameter);
    ``replay``: update_grad_input re-runs the forward under the
    generator state the forward drew from."""
    m = tnn.Sequential(tnn.CMul([16], device="cpu"),
                       tnn.Dropout(0.5, device="cpu"))
    x = torch.randn(16, 16, generator=torch.Generator().manual_seed(1))
    y = m.forward(x)
    assert 0.2 < float((y == 0).float().mean()) < 0.8
    go = torch.ones(16, 16)
    gi = m.backward(x, go) if path == "graph" \
        else m.update_grad_input(x, go)
    assert torch.equal(gi == 0, y == 0)


def test_dropout_layer_matches_jax_in_eval_and_keep_share():
    x = np.random.RandomState(2).randn(3, 6).astype(np.float32)
    j, p = jnn.Dropout(0.3), tnn.Dropout(0.3, device="cpu")
    j.evaluate()
    np.testing.assert_array_equal(
        p.evaluate().forward(torch.as_tensor(x)).numpy(),
        np.asarray(j.forward(x)))


def test_eval_forward_equals_the_dropout_free_model_and_jax():
    ids = _ids()
    drop, plain = _lm(0.1), _lm(0.0)
    plain.set_param_tree(drop.param_tree())
    with torch.no_grad():
        got = drop.evaluate().forward(ids)
        assert torch.equal(got, plain.evaluate().forward(ids))
    jm = JTransformerLM(V, **LM_KW, dropout=0.1)
    load_param_tree(drop, jax.tree_util.tree_map(np.asarray,
                                                 jm.param_tree()))
    jm.evaluate()
    with torch.no_grad():
        got = drop.forward(ids)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jm.forward(ids.numpy())), **TOL)


def test_training_forwards_same_seed_same_bits_other_seed_differs():
    m, ids = _lm(0.1).train(), _ids()

    def run(seed):
        with torch.no_grad(), tnn.rng_scope(
                torch.Generator().manual_seed(seed)):
            return m.forward(ids)

    a, b, c = run(3), run(3), run(4)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    with torch.no_grad():
        assert not torch.equal(a, m.evaluate().forward(ids))


def test_residual_mask_keep_share():
    from bigdl_tpu_torch.nn.dropout import dropout

    n = 64 * 1024
    y = dropout(torch.ones(n), 0.1, torch.Generator().manual_seed(0))
    share = float((y != 0).float().mean())
    sigma = math.sqrt(0.9 * 0.1 / n)
    assert abs(share - 0.9) < 5 * sigma
    torch.testing.assert_close(y[y != 0], torch.full((int((y != 0).sum()),),
                                                      1 / 0.9))


def _samples(n=16, seed=0):
    """Sequences whose target is the input: learnable in a few steps."""
    rng = np.random.RandomState(seed)
    x = rng.randint(1, V + 1, size=(n, T_LEN)).astype(np.int32)
    return array([Sample(a, a.copy()) for a in x])


def _train(model, iters, ckpt=None, resume=None):
    opt = LocalOptimizer(model, _samples(), tnn.TimeDistributedCriterion(
        tnn.CrossEntropyCriterion(), True), batch_size=BATCH)
    opt.set_optim_method(SGD(0.5))
    losses = []

    def end(state):
        if "loss" in state:
            losses.append(state["loss"])
        return max_iteration(iters)(state)

    opt.set_end_when(end)
    if ckpt is not None:
        opt.set_checkpoint(ckpt, several_iteration(4))
    RNG().set_seed(1)
    if resume is not None:
        assert opt.resume_from_checkpoint(resume) is True
    opt.optimize()
    return losses


def test_transformer_with_dropout_trains_under_local_optimizer():
    losses = _train(_lm(0.1), 8)
    assert len(losses) == 8 and all(math.isfinite(v) for v in losses)
    assert losses[-1] < losses[0]


def test_resume_with_dropout_is_bitwise_the_uninterrupted_run(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    ref_model = _lm(0.1)
    ref = _train(ref_model, 8, ckpt)
    again = _lm(0.1)
    assert _train(again, 8) == ref                 # dropout is seeded
    resumed = _lm(0.1, seed=7)
    got = _train(resumed, 8, ckpt, resume=4)
    assert got[-4:] == ref[4:]
    for (name, p), q in zip(ref_model.named_parameters(),
                            resumed.parameters()):
        assert torch.equal(p, q), name
    plain = _train(_lm(0.0), 8)
    assert plain != ref                            # the masks mattered
