"""The port's recurrent stack (bigdl_tpu_torch.nn.recurrent and
models/rnn.py) against the JAX package's and against torch.nn's RNNs,
in f32 on the CPU.

The first nine tests mirror ``tests/test_recurrent.py`` spec for spec,
with the same torch-RNN oracles.  Then every cell, ``Recurrent`` (both
directions), ``BiRecurrent`` (with and without a merge module) and
``TimeDistributed`` run beside the JAX layer on carried weights
(``run_pair``: forward, input and parameter gradients at the layer
zoo's tolerance), a cell alone takes one step on a ``Table``, and
``SimpleRNN`` and ``LSTMClassifier`` (LSTM and GRU cells) train a short
``LocalOptimizer`` trajectory beside the JAX one at rtol 2e-3.  The
port is held to the JAX package's numbers, not to the accuracy
thresholds of ``tests/test_accuracy_proof.py``.
"""
import numpy as np
import pytest
import torch

import jax

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.dataset.dataset import array as jarray
from bigdl_tpu.models.rnn import LSTMClassifier as JLSTMClassifier
from bigdl_tpu.models.rnn import SimpleRNN as JSimpleRNN
from bigdl_tpu.optim.optimizer import LocalOptimizer as JLocalOptimizer
from bigdl_tpu.utils.rng import RNG as JRNG
from bigdl_tpu_torch import nn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.dataset import Sample, array
from bigdl_tpu_torch.interop import load_param_tree
from bigdl_tpu_torch.models.rnn import LSTMClassifier, SimpleRNN
from bigdl_tpu_torch.nn.recurrent import (GRU, LSTM, BiRecurrent,
                                          ConvLSTMPeephole, LSTMPeephole,
                                          Recurrent, RnnCell, TimeDistributed)
from bigdl_tpu_torch.utils.rng import RNG
from bigdl_tpu_torch.utils.table import Table
from test_torch_layer_zoo import T, flat_tree, run_pair

torch.set_num_threads(1)

CPU = dict(device="cpu")
X = np.random.RandomState(3).randn(2, 5, 4).astype(np.float32)  # (N, T, F)
TRAJ_RTOL = 2e-3


def _oracle(m, t):
    cp = m.cell
    with torch.no_grad():
        t.weight_ih_l0.copy_(cp.i2h)
        t.weight_hh_l0.copy_(cp.h2h)
        t.bias_ih_l0.copy_(cp.bias)
        t.bias_hh_l0.zero_()
    y = m.forward(torch.from_numpy(X))
    yt, _ = t(torch.from_numpy(X))
    np.testing.assert_allclose(y.detach().numpy(), yt.detach().numpy(),
                               atol=1e-5)


# ---------------------------------------------------- tests/test_recurrent.py

def test_rnn_cell_matches_torch():
    _oracle(Recurrent(RnnCell(4, 6, **CPU)),
            torch.nn.RNN(4, 6, batch_first=True))


def test_lstm_matches_torch():
    # the gate order (i, f, z, o) is torch's (i, f, g, o)
    _oracle(Recurrent(LSTM(4, 6, **CPU)),
            torch.nn.LSTM(4, 6, batch_first=True))


def test_gru_matches_torch():
    # torch: n = tanh(W_in x + b_in + r * (W_hn h + b_hn)); with b_hh = 0
    # this is the cell's formulation exactly
    _oracle(Recurrent(GRU(4, 6, **CPU)),
            torch.nn.GRU(4, 6, batch_first=True))


def test_lstm_backward_flows():
    m = Recurrent(LSTM(4, 6, **CPU))
    x = torch.from_numpy(X)
    m.forward(x)
    gi = m.backward(x, torch.ones(2, 5, 6))
    assert tuple(gi.shape) == X.shape
    _, grads = m.weights_and_grads()
    assert all(bool((g != 0).any()) for g in grads)


def test_lstm_peephole_runs():
    m = Recurrent(LSTMPeephole(4, 6, **CPU))
    assert tuple(m.forward(torch.from_numpy(X)).shape) == (2, 5, 6)


def test_birecurrent():
    m = BiRecurrent().add(LSTM(4, 6, **CPU))
    x = torch.from_numpy(X)
    y = m.forward(x)
    assert tuple(y.shape) == (2, 5, 6)
    # the reversed pass contributes
    f = Recurrent(LSTM(4, 6, **CPU))
    f.cell.set_param_tree(m.fwd.cell.param_tree())
    assert not np.allclose(y.detach().numpy(), f.forward(x).detach().numpy())


def test_conv_lstm_peephole():
    m = Recurrent(ConvLSTMPeephole(3, 8, 3, 3, **CPU))
    x = np.random.RandomState(4).randn(2, 4, 3, 6, 6).astype(np.float32)
    assert tuple(m.forward(torch.from_numpy(x)).shape) == (2, 4, 8, 6, 6)


def test_time_distributed():
    m = TimeDistributed(nn.Linear(4, 3, **CPU))
    x = torch.from_numpy(X)
    y = m.forward(x)
    assert tuple(y.shape) == (2, 5, 3)
    lin = nn.Linear(4, 3, **CPU)
    lin.set_param_tree(m.module.param_tree())
    per_t = torch.stack([lin.forward(x[:, i]) for i in range(5)], dim=1)
    np.testing.assert_allclose(y.detach().numpy(), per_t.detach().numpy(),
                               atol=1e-6)


def test_simple_rnn_trains():
    """SimpleRNN LM smoke (reference models/rnn/): the loss falls below
    chance."""
    V, Tn = 20, 6
    rng = np.random.RandomState(0)
    seqs = rng.randint(0, V, (64, Tn + 1))
    samples = [Sample(np.eye(V, dtype=np.float32)[s[:-1]],
                      (s[1:] + 1).astype(np.float32)) for s in seqs]
    RNG().set_seed(1)
    model = SimpleRNN(V, 16, V, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion(), True)
    opt = toptim.LocalOptimizer(model, array(samples), crit, batch_size=16)
    opt.set_optim_method(toptim.SGD(0.5))
    opt.set_end_when(toptim.max_iteration(30))
    opt.optimize()
    x = torch.from_numpy(np.stack([s.feature for s in samples[:16]]))
    t = torch.from_numpy(np.stack([s.label for s in samples[:16]]))
    with torch.no_grad():
        final = crit.forward(model.forward(x), t)
    assert float(final) < np.log(V)


# ---------------------------------------------------- against the JAX layers

def _cells(pkg, **kw):
    return {
        "rnn": lambda: pkg.RnnCell(4, 6, **kw),
        "lstm": lambda: pkg.LSTM(4, 6, **kw),
        "lstm_peephole": lambda: pkg.LSTMPeephole(4, 6, **kw),
        "gru": lambda: pkg.GRU(4, 6, **kw),
    }


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("cell", ["rnn", "lstm", "lstm_peephole", "gru"])
def test_recurrent_matches_jax(cell, reverse):
    jm = jnn.Recurrent(_cells(jnn)[cell](), reverse=reverse)
    pm = Recurrent(_cells(nn, **CPU)[cell](), reverse=reverse)
    assert sorted(flat_tree(pm.param_tree())) == sorted(flat_tree(
        jax.tree_util.tree_map(np.asarray, jm.param_tree())))
    run_pair(jm, pm, X)


def test_conv_lstm_peephole_matches_jax():
    x = np.random.RandomState(4).randn(2, 3, 3, 5, 5).astype(np.float32)
    for peep in (True, False):
        jm = jnn.Recurrent(jnn.ConvLSTMPeephole(3, 4, 3, 3,
                                                with_peephole=peep))
        pm = Recurrent(ConvLSTMPeephole(3, 4, 3, 3, with_peephole=peep,
                                        **CPU))
        run_pair(jm, pm, x)


@pytest.mark.parametrize("merge", [None, "join"])
def test_birecurrent_matches_jax(merge):
    jm = jnn.BiRecurrent(None if merge is None else jnn.JoinTable(3))
    pm = BiRecurrent(None if merge is None else nn.JoinTable(3, **CPU))
    jm.add(jnn.GRU(4, 6))
    pm.add(GRU(4, 6, **CPU), generator=torch.Generator().manual_seed(1))
    got, _ = run_pair(jm, pm, X)
    assert tuple(got.shape) == (2, 5, 6 if merge is None else 12)


def test_time_distributed_matches_jax():
    jm = jnn.TimeDistributed(jnn.Linear(4, 3))
    pm = TimeDistributed(nn.Linear(4, 3, **CPU))
    run_pair(jm, pm, X)


@pytest.mark.parametrize("cell", ["rnn", "lstm", "gru"])
def test_cell_step_on_a_table_matches_jax(cell):
    """A cell alone: ``Table(x_t, hidden)`` → ``Table(out, hidden')``."""
    rng = np.random.RandomState(6)
    x_t = rng.randn(2, 4).astype(np.float32)
    h = rng.randn(2, 6).astype(np.float32)
    c = rng.randn(2, 6).astype(np.float32)
    hidden = T(h, c) if cell == "lstm" else h
    got, _ = run_pair(_cells(jnn)[cell](), _cells(nn, **CPU)[cell](),
                      T(x_t, hidden))
    assert isinstance(got, Table) and tuple(got[1].shape) == (2, 6)
    if cell == "lstm":
        assert isinstance(got[2], Table)
        assert torch.equal(got[1], got[2][1])


# ---------------------------------------------------- trajectories

def _trajectory(jmodel, pmodel, xs, ys, jcrit, pcrit, lr, iters, batch):
    load_param_tree(pmodel, jax.tree_util.tree_map(np.asarray,
                                                   jmodel.param_tree()))
    losses = {}
    for tag, model, opt_pkg, rng, samples, crit, Opt in (
            ("jax", jmodel, joptim, JRNG,
             jarray([JSample(a, b) for a, b in zip(xs, ys)]), jcrit,
             JLocalOptimizer),
            ("port", pmodel, toptim, RNG,
             array([Sample(a, b) for a, b in zip(xs, ys)]), pcrit,
             toptim.LocalOptimizer)):
        seen = []

        def check(state, seen=seen, opt_pkg=opt_pkg):
            if "loss" in state:
                seen.append(state["loss"])
            return opt_pkg.max_iteration(iters)(state)

        opt = Opt(model, samples, crit, batch_size=batch)
        opt.set_optim_method(opt_pkg.SGD(lr))
        opt.set_end_when(opt_pkg.Trigger(check))
        rng().set_seed(1)
        opt.optimize()
        losses[tag] = seen
    assert len(losses["port"]) == len(losses["jax"]) == iters
    np.testing.assert_allclose(losses["port"], losses["jax"],
                               rtol=TRAJ_RTOL)
    want = flat_tree(jax.tree_util.tree_map(np.asarray, jmodel.param_tree()))
    got = flat_tree(pmodel.param_tree())
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TRAJ_RTOL,
                                   atol=1e-6, err_msg=k)
    return losses["port"]


def test_simple_rnn_trajectory_matches_jax():
    V, H, Tn, N = 24, 12, 7, 32
    rng = np.random.RandomState(8)
    seqs = rng.randint(0, V, (N, Tn + 1))
    xs = np.eye(V, dtype=np.float32)[seqs[:, :-1]]
    ys = (seqs[:, 1:] + 1).astype(np.float32)
    losses = _trajectory(
        JSimpleRNN(V, H, V), SimpleRNN(V, H, V, **CPU), xs, ys,
        jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion(), True),
        nn.TimeDistributedCriterion(nn.ClassNLLCriterion(), True),
        lr=0.5, iters=6, batch=8)
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_lstm_classifier_trajectory_matches_jax(cell):
    V, E, H, C, Tn, N = 30, 8, 10, 4, 9, 24
    rng = np.random.RandomState(9)
    xs = rng.randint(1, V + 1, (N, Tn)).astype(np.int32)
    xs[:, :2] = 1          # the padding id leads every sequence
    ys = rng.randint(1, C + 1, N).astype(np.float32)
    losses = _trajectory(
        JLSTMClassifier(V, E, H, C, padding_value=1, cell=cell),
        LSTMClassifier(V, E, H, C, padding_value=1, cell=cell, **CPU),
        xs, ys, jnn.ClassNLLCriterion(), nn.ClassNLLCriterion(),
        lr=0.3, iters=6, batch=8)
    assert all(np.isfinite(losses))


def test_lstm_classifier_rejects_an_unknown_cell():
    with pytest.raises(ValueError):
        LSTMClassifier(10, 4, 4, 2, cell="rnn", **CPU)
