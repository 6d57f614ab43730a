"""The port's training slice against the JAX package on the CPU: the
criterions, SGD and Adam, the triggers, the epoch order and its
shuffle, the gradient guard, the bf16 cast of float ids, and a
6-iteration ``LocalOptimizer`` trajectory of a small TransformerLM
whose weights are carried across with ``load_param_tree``.

Inputs are made with numpy from a seed and handed to both packages;
the comparisons are in f32.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.dataset import SampleToMiniBatch as JToBatch
from bigdl_tpu.dataset.dataset import array as jarray
from bigdl_tpu.models.transformer import TransformerLM as JTransformerLM
from bigdl_tpu.optim.optimizer import LocalOptimizer as JLocalOptimizer
from bigdl_tpu.optim.optimizer import _cast_floats as jax_cast_floats
from bigdl_tpu.utils.rng import RNG as JRNG
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.dataset import Sample, SampleToMiniBatch, array
from bigdl_tpu_torch.interop import load_param_tree
from bigdl_tpu_torch.interop.jax_params import param_tree_numpy
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.optim.optimizer import LocalOptimizer, cast_floats
from bigdl_tpu_torch.utils.rng import RNG
from bigdl_tpu_torch.utils.table import T

# The suite runs in several processes at once: one intra-op thread each
# keeps these small tensors from crowding the timing-sensitive tests.
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
# the trajectory tolerance of tests/test_sharding_plan.py
TRAJ_RTOL = 2e-3


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ----------------------------------------------------------------------
# criterions
# ----------------------------------------------------------------------

def _class_inputs(N, C, seed, log_probs=False):
    rng = np.random.RandomState(seed)
    x = (rng.randn(N, C) * 2).astype(np.float32)
    if log_probs:
        x = x - np.log(np.exp(x).sum(-1, keepdims=True))
    t = rng.randint(1, C + 1, size=N).astype(np.int32)   # 1-based
    return x, t


def _crit_pair(jc, tc, x, t):
    """Loss value and gradient wrt the input, both packages."""
    want = jc._loss(jnp.asarray(x), jnp.asarray(t))
    want_g = jax.grad(lambda a: jc._loss(a, jnp.asarray(t)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = tc._loss(xt, torch.from_numpy(t))
    (got_g,) = torch.autograd.grad(got, xt)
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **TOL)


WEIGHTS = np.array([0.5, 1.0, 2.0, 1.5, 0.25, 1.0, 3.0], np.float32)


@pytest.mark.parametrize("size_average", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
def test_class_nll_matches_jax(size_average, weighted):
    x, t = _class_inputs(9, 7, seed=1, log_probs=True)
    w = WEIGHTS if weighted else None
    _crit_pair(jnn.ClassNLLCriterion(w, size_average),
               tnn.ClassNLLCriterion(w, size_average), x, t)


@pytest.mark.parametrize("size_average", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy_matches_jax(size_average, weighted):
    x, t = _class_inputs(9, 7, seed=2)
    w = WEIGHTS if weighted else None
    jc = jnn.CrossEntropyCriterion(w, size_average)
    tc = tnn.CrossEntropyCriterion(w, size_average)
    assert tc.accepts_low_precision == jc.accepts_low_precision
    _crit_pair(jc, tc, x, t)


@pytest.mark.parametrize("inner_size_average", [True, False])
@pytest.mark.parametrize("size_average", [True, False])
def test_time_distributed_matches_jax(size_average, inner_size_average):
    # inner size_average True takes the flattened path, False the
    # per-step one
    rng = np.random.RandomState(3)
    x = rng.randn(3, 5, 11).astype(np.float32)
    t = rng.randint(1, 12, size=(3, 5)).astype(np.int32)
    jc = jnn.TimeDistributedCriterion(
        jnn.CrossEntropyCriterion(size_average=inner_size_average),
        size_average)
    tc = tnn.TimeDistributedCriterion(
        tnn.CrossEntropyCriterion(size_average=inner_size_average),
        size_average)
    assert tc.accepts_low_precision == jc.accepts_low_precision
    _crit_pair(jc, tc, x, t)


def test_criterion_forward_backward_and_float_targets():
    x, t = _class_inputs(4, 5, seed=4)
    tf = t.astype(np.float32)          # 1-based float labels
    jc, tc = jnn.CrossEntropyCriterion(), tnn.CrossEntropyCriterion()
    np.testing.assert_allclose(tc.forward(x, tf), jc.forward(x, tf), **TOL)
    np.testing.assert_allclose(tc.backward(x, tf).numpy(),
                               np.asarray(jc.backward(x, tf)), **TOL)


# ----------------------------------------------------------------------
# optim methods
# ----------------------------------------------------------------------

def _trees(seed):
    rng = np.random.RandomState(seed)
    params = {"w": rng.randn(4, 3).astype(np.float32),
              "sub": {"b": rng.randn(3).astype(np.float32)}}
    grads = [{"w": rng.randn(4, 3).astype(np.float32),
              "sub": {"b": rng.randn(3).astype(np.float32)}}
             for _ in range(2)]
    return params, grads


def _run_steps(method, params, grads, lr, to_tensor, from_tensor):
    p = jax.tree_util.tree_map(to_tensor, params)
    slots = method.init_state(p)
    for g in grads:
        p, slots = method.step(jax.tree_util.tree_map(to_tensor, g), p,
                               slots, lr)
    return jax.tree_util.tree_map(from_tensor, p)


def _both(jmethod, tmethod, n_steps, lr=0.05):
    params, grads = _trees(5)
    grads = grads[:n_steps]
    want = _run_steps(jmethod, params, grads, lr, jnp.asarray, np.asarray)
    got = _run_steps(tmethod, params, grads, lr, torch.from_numpy,
                     lambda a: a.numpy())
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("kw", [
    dict(), dict(weight_decay=0.1), dict(momentum=0.9),
    dict(momentum=0.9, dampening=0.0, nesterov=True),
    dict(momentum=0.9, dampening=0.0, nesterov=True, weight_decay=0.01)],
    ids=["plain", "weight_decay", "momentum", "nesterov", "nesterov_wd"])
def test_sgd_steps_match_jax(kw):
    _both(joptim.SGD(0.05, **kw), toptim.SGD(0.05, **kw), n_steps=2)


def test_adam_two_steps_match_jax():
    _both(joptim.Adam(1e-2), toptim.Adam(1e-2), n_steps=2, lr=1e-2)


def test_schedules_match_jax():
    for jm, tm in ((joptim.SGD(0.1, learning_rate_decay=0.5),
                    toptim.SGD(0.1, learning_rate_decay=0.5)),
                   (joptim.Adam(0.1, learning_rate_decay=0.25),
                    toptim.Adam(0.1, learning_rate_decay=0.25))):
        for neval in (1, 2, 7):
            jm.state["neval"] = neval
            tm.state["neval"] = neval
            assert tm.get_current_lr() == jm.get_current_lr()


def test_nesterov_contract_raises():
    with pytest.raises(ValueError):
        toptim.SGD(0.1, momentum=0.9, nesterov=True)


# ----------------------------------------------------------------------
# triggers
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name,arg", [
    ("max_epoch", 2), ("max_iteration", 5), ("several_iteration", 3),
    ("every_epoch", None)])
def test_triggers_match_jax(name, arg):
    jtrig = getattr(joptim, name)(*(() if arg is None else (arg,)))
    ttrig = getattr(toptim, name)(*(() if arg is None else (arg,)))
    for epoch in (1, 2, 3):
        for neval in range(1, 9):
            for finished in (False, True):
                kw = dict(epoch=epoch, neval=neval, epoch_finished=finished)
                assert ttrig(T(**kw)) == jtrig(JT(**kw))
    both = toptim.max_iteration(4).or_(toptim.max_epoch(1))
    assert both(T(epoch=2, neval=1)) and not both(T(epoch=1, neval=4))


# ----------------------------------------------------------------------
# datasets: the epoch order and its shuffle
# ----------------------------------------------------------------------

def test_epoch_order_and_shuffle_match_jax():
    n, bs = 10, 4
    jds = jarray([JSample(np.array([i]), np.array([i])) for i in range(n)])
    tds = array([Sample(np.array([i]), np.array([i])) for i in range(n)])
    jds, tds = jds.transform(JToBatch(bs)), tds.transform(SampleToMiniBatch(bs))
    JRNG().set_seed(7)
    RNG().set_seed(7)
    orders = []
    for ds in (jds, tds):
        seen = []
        for _ in range(3):   # three epochs, shuffled between them
            it = ds.data(train=True)
            got = 0
            while got < n:
                b = next(it)
                seen.append(np.asarray(b.get_input())[:, 0].tolist())
                got += b.size()
            ds.shuffle()
        orders.append(seen)
    assert orders[0] == orders[1]
    assert orders[1][0] != orders[1][3]   # the shuffle did reorder


# ----------------------------------------------------------------------
# the local training loop
# ----------------------------------------------------------------------

def test_float_ids_round_in_bf16_like_jax():
    ids = np.array([[255.0, 257.0, 1001.0, 31999.0]], np.float32)
    want = np.asarray(jax_cast_floats(jnp.asarray(ids), jnp.bfloat16)
                      .astype(jnp.float32))
    got = cast_floats(torch.from_numpy(ids), torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [[255, 256, 1000, 32000]])
    ints = torch.tensor([[257, 31999]], dtype=torch.int32)
    assert cast_floats(ints, torch.bfloat16) is ints   # ids pass untouched


def _linear_problem(nan_row: bool):
    rng = np.random.RandomState(11)
    xs = rng.randn(8, 6).astype(np.float32)
    if nan_row:
        xs[3, 2] = np.nan
    ys = rng.randint(1, 4, size=8).astype(np.int32)
    return array([Sample(x, y) for x, y in zip(xs, ys)])


@pytest.mark.parametrize("nan_row", [True, False])
def test_gradient_guard_skips_a_nan_step(nan_row):
    model = tnn.Linear(6, 3, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt = LocalOptimizer(model, _linear_problem(nan_row),
                         tnn.CrossEntropyCriterion(), batch_size=8)
    opt.set_optim_method(toptim.SGD(0.1, momentum=0.9))
    opt.set_end_when(toptim.max_iteration(1))
    opt.optimize()
    after = model.state_dict()
    same = all(torch.equal(before[k], after[k]) for k in before)
    assert same == nan_row
    assert opt.skipped_steps == int(nan_row)
    velocity = opt.optim_method._slots["velocity"]["weight"]
    assert bool((velocity == 0).all()) == nan_row


def test_unported_optimizer_options_raise():
    opt = LocalOptimizer(tnn.Linear(6, 3, device="cpu"),
                         _linear_problem(False), tnn.CrossEntropyCriterion(),
                         batch_size=8)
    for call in (lambda: opt.set_checkpoint("/nonexistent", None,
                                            format="orbax"),
                 lambda: opt.set_elastic(None)):
        with pytest.raises(NotImplementedError):
            call()
    with pytest.raises(ValueError):
        opt.set_compute_dtype(torch.int32)
    # telemetry is ported: attaching and detaching a bundle works
    assert opt.set_telemetry(None) is opt and opt.telemetry is None


def test_train_sets_mode_and_requires_grad():
    model = TransformerLM(16, embed_dim=8, num_heads=2, num_layers=1,
                          max_len=4, device="cpu")
    for p in model.parameters():
        p.requires_grad_(False)
    model.evaluate()
    assert not model.training
    assert model.train() is model and model.training
    assert all(p.requires_grad for p in model.parameters())
    model.train(False)
    assert not model.training


# the trajectory: V 64, D 32, 2 heads, 2 layers, T 16, B 4, 16 samples,
# 6 iterations (an epoch is 4: the run crosses a shuffle)
V, D, HEADS, LAYERS, T_LEN, BATCH, N_SAMPLES, ITERS = 64, 32, 2, 2, 16, 4, 16, 6


def _lm_data():
    rng = np.random.RandomState(0)
    x = rng.randint(1, V + 1, size=(N_SAMPLES, T_LEN)).astype(np.int32)
    y = rng.randint(1, V + 1, size=(N_SAMPLES, T_LEN)).astype(np.int32)
    return x, y


LM_KW = dict(embed_dim=D, num_heads=HEADS, num_layers=LAYERS,
             max_len=T_LEN, seq_strategy="flash", output="logits")


def _recording(trigger, losses):
    """``trigger``, recording the state's loss each time the loop asks
    (after every iteration)."""
    def check(state):
        if "loss" in state:
            losses.append(state["loss"])
        return trigger(state)

    return check


def _run(opt, optim_pkg, method, rng):
    """Train ``opt`` for ITERS iterations from host seed 1; returns the
    per-iteration losses."""
    losses = []
    opt.set_optim_method(method)
    opt.set_end_when(optim_pkg.Trigger(_recording(
        optim_pkg.max_iteration(ITERS), losses)))
    rng().set_seed(1)
    opt.optimize()
    return losses


@pytest.mark.parametrize("which", ["sgd_momentum", "adam"])
def test_local_optimizer_trajectory_matches_jax(which):
    make = {"sgd_momentum": lambda m: m.SGD(0.05, momentum=0.9),
            "adam": lambda m: m.Adam(3e-3)}[which]
    x, y = _lm_data()
    jmodel = JTransformerLM(V, **LM_KW)
    tmodel = TransformerLM(V, **LM_KW, device="cpu")
    load_param_tree(tmodel, _to_np(jmodel.param_tree()))

    jopt = JLocalOptimizer(
        jmodel, jarray([JSample(a, b) for a, b in zip(x, y)]),
        jnn.TimeDistributedCriterion(jnn.CrossEntropyCriterion(), True),
        batch_size=BATCH)
    topt = LocalOptimizer(
        tmodel, array([Sample(a, b) for a, b in zip(x, y)]),
        tnn.TimeDistributedCriterion(tnn.CrossEntropyCriterion(), True),
        batch_size=BATCH)
    jlosses = _run(jopt, joptim, make(joptim), JRNG)
    tlosses = _run(topt, toptim, make(toptim), RNG)

    assert len(tlosses) == len(jlosses) == ITERS
    assert topt.optim_method.state["epoch"] == 2
    assert jopt.optim_method.state["epoch"] == 2
    assert topt.skipped_steps == jopt.skipped_steps == 0
    np.testing.assert_allclose(tlosses, jlosses, rtol=TRAJ_RTOL)
    want = jax.tree_util.tree_flatten_with_path(_to_np(jmodel.param_tree()))[0]
    got = jax.tree_util.tree_leaves(param_tree_numpy(tmodel))
    assert len(want) == len(got)
    for (path, w), g in zip(want, got):
        name = jax.tree_util.keystr(path)
        if name.endswith("['bk']") and which == "adam":
            # bk adds one vector to every key: a shift of each score row,
            # which the softmax cancels, so its gradient is zero in exact
            # arithmetic and both packages hold only rounding noise
            # (~1e-10).  Adam divides that noise by its own size, so each
            # side moves bk by up to lr per step, in its own direction.
            assert np.abs(g).max() <= ITERS * 3e-3 * 1.01
            assert np.abs(w).max() <= ITERS * 3e-3 * 1.01
            continue
        # atol 1e-6: the same zero-gradient noise under SGD stays ~1e-10
        np.testing.assert_allclose(g, w, rtol=TRAJ_RTOL, atol=1e-6,
                                   err_msg=name)
