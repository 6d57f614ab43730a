"""Optim breadth on the port against the JAX package, on the CPU: the
optim methods (Adagrad, Adadelta, Adamax, RMSprop, LBFGS), every
learning-rate schedule, the Torch-parity ``optimize(feval, x)``, slots
through ``save``/``load``, the regularizers, the gradient scales of
``set_scale_w``/``set_scale_b`` in the training step (F7), the
``torch.optim`` bridge against ``OptaxMethod``, ``LookupTable``'s max
norm, the layers' JAX signatures, the fsspec backend, ``rdd``,
``train_more`` and the straggler knobs.

Inputs are made with numpy from a seed and handed to both packages;
weights cross with ``load_param_tree``.  Tolerances are
``test_torch_training.py``'s: ``TOL`` for one op or a few steps, rtol
2e-3 for trajectories.
"""
import logging
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.dataset.dataset import array as jarray
from bigdl_tpu.models.transformer import TransformerLM as JTransformerLM
from bigdl_tpu.optim import regularizer as jreg
from bigdl_tpu.utils.rng import RNG as JRNG
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.dataset import Sample, array, rdd, ShardedDataSet
from bigdl_tpu_torch.interop import load_param_tree
from bigdl_tpu_torch.interop.jax_params import param_tree_numpy
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.optim import regularizer as treg
from bigdl_tpu_torch.utils import file_io
from bigdl_tpu_torch.utils.rng import RNG
from bigdl_tpu_torch.utils.table import T
from bigdl_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
TRAJ_RTOL = 2e-3
CPU = dict(device="cpu")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close_trees(got, want, **tol):
    """Leaf by leaf in JAX's key order (each package's dicts keep their
    own insertion order)."""
    def as_np(t):
        return np.asarray(t.detach() if torch.is_tensor(t) else t)

    g = jax.tree_util.tree_leaves(jax.tree_util.tree_map(as_np, got))
    w = jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   **(tol or TOL))


# ----------------------------------------------------------------------
# the methods' steps (test_torch_training.py's _both)
# ----------------------------------------------------------------------

def _trees(seed, n=3):
    rng = np.random.RandomState(seed)
    params = {"w": rng.randn(4, 3).astype(np.float32),
              "sub": {"b": rng.randn(3).astype(np.float32)}}
    grads = [{"w": rng.randn(4, 3).astype(np.float32),
              "sub": {"b": rng.randn(3).astype(np.float32)}}
             for _ in range(n)]
    return params, grads


def _run_steps(method, params, grads, lr, conv):
    tmap = jax.tree_util.tree_map
    p = tmap(conv, params)
    slots = method.init_state(p)
    for g in grads:
        p, slots = method.step(tmap(conv, g), p, slots, lr)
    return p


def _both(jmethod, tmethod, lr, n_steps=3):
    params, grads = _trees(5, n_steps)
    want = _run_steps(jmethod, params, grads, lr, jnp.asarray)
    got = _run_steps(tmethod, params, grads, lr, torch.from_numpy)
    _close_trees(got, want)


METHODS = {
    "Adagrad": (lambda m, **kw: m.Adagrad(0.05, **kw), True),
    "Adadelta": (lambda m, **kw: m.Adadelta(0.9, 1e-2), False),
    "Adamax": (lambda m, **kw: m.Adamax(0.05), False),
    "RMSprop": (lambda m, **kw: m.RMSprop(0.05), False),
}
METHOD_CASES = [(name, wd) for name, (_, has_wd) in METHODS.items()
                for wd in ((0.0, 0.1) if has_wd else (0.0,))]


@pytest.mark.parametrize("name,weight_decay", METHOD_CASES,
                         ids=[f"{n}-wd{w}" for n, w in METHOD_CASES])
def test_method_three_steps_match_jax(name, weight_decay):
    make, has_wd = METHODS[name]
    kw = dict(weight_decay=weight_decay) if has_wd else {}
    jm, tm = make(joptim, **kw), make(toptim, **kw)
    _both(jm, tm, jm.get_current_lr())


@pytest.mark.parametrize("name", ["Adagrad", "RMSprop"])
def test_method_learning_rate_decay_matches_jax(name):
    cls = {"Adagrad": "Adagrad", "RMSprop": "RMSprop"}[name]
    jm = getattr(joptim, cls)(0.1, learning_rate_decay=0.5)
    tm = getattr(toptim, cls)(0.1, learning_rate_decay=0.5)
    for neval in range(1, 8):
        jm.state["neval"] = tm.state["neval"] = neval
        assert tm.get_current_lr() == jm.get_current_lr()


# ----------------------------------------------------------------------
# schedules: every one over neval and epoch 1..30
# ----------------------------------------------------------------------

SCHEDULES = {
    "Default": lambda m: None,
    "Step": lambda m: m.Step(4, 0.5),
    "MultiStep": lambda m: m.MultiStep([3, 10, 20], 0.1),
    "EpochStep": lambda m: m.EpochStep(3, 0.5),
    "EpochDecay": lambda m: m.EpochDecay(lambda e: e // 7),
    "EpochSchedule": lambda m: m.EpochSchedule([(1, 5, 0.3), (6, 12, 0.03),
                                                (13, 20, 0.003)]),
    "Poly": lambda m: m.Poly(2.0, 17),
    "Exponential": lambda m: m.Exponential(4, 0.7),
    "Exponential-stair": lambda m: m.Exponential(4, 0.7, stair_case=True),
    "NaturalExp": lambda m: m.NaturalExp(3, 0.2),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_learning_rates_match_jax(name):
    """lr at every (neval, epoch) in 1..30 x 1..30, Poly also past its
    max_iteration (17)."""
    jm = joptim.SGD(0.5, learning_rate_decay=0.1,
                    learning_rate_schedule=SCHEDULES[name](joptim))
    tm = toptim.SGD(0.5, learning_rate_decay=0.1,
                    learning_rate_schedule=SCHEDULES[name](toptim))
    for neval in range(1, 31):
        for epoch in range(1, 31):
            jm.state = JT(neval=neval, epoch=epoch)
            tm.state = T(neval=neval, epoch=epoch)
            assert tm.get_current_lr() == jm.get_current_lr(), \
                (neval, epoch)
    if name == "Poly":
        tm.state = T(neval=40, epoch=1)
        assert tm.get_current_lr() == 0.0


@pytest.mark.parametrize("mode,patience,cooldown", [
    ("min", 2, 0), ("min", 3, 2), ("max", 2, 0), ("max", 1, 3)])
def test_plateau_matches_jax(mode, patience, cooldown):
    """Plateau reads the state's score (the validation's), steps down
    after ``patience`` checks without a gain, then waits ``cooldown``."""
    rng = np.random.RandomState(3)
    scores = np.concatenate([np.linspace(1.0, 0.5, 6),
                             0.5 + 0.001 * rng.randn(20),
                             np.linspace(0.5, 0.2, 4)])
    if mode == "max":
        scores = 1.0 - scores
    jm = joptim.SGD(0.4, learning_rate_schedule=joptim.Plateau(
        "score", factor=0.5, patience=patience, mode=mode,
        cooldown=cooldown, min_lr=0.01))
    tm = toptim.SGD(0.4, learning_rate_schedule=toptim.Plateau(
        "score", factor=0.5, patience=patience, mode=mode,
        cooldown=cooldown, min_lr=0.01))
    got, want = [], []
    for i, s in enumerate(scores):
        jm.state["score"] = tm.state["score"] = float(s)
        want.append(jm.get_current_lr())
        got.append(tm.get_current_lr())
    assert got == want
    assert min(got) < 0.4   # it did step down


def test_plateau_reads_the_loss_before_a_score():
    jm = joptim.SGD(0.4, learning_rate_schedule=joptim.Plateau(patience=1))
    tm = toptim.SGD(0.4, learning_rate_schedule=toptim.Plateau(patience=1))
    for loss in (1.0, 1.0, 1.0, 0.5, 0.5):
        jm.state["loss"] = tm.state["loss"] = loss
        assert tm.get_current_lr() == jm.get_current_lr()
    assert tm.get_current_lr() < 0.4


# ----------------------------------------------------------------------
# optimize(feval, x) and LBFGS (tests/test_local_optimizer.py:137-178)
# ----------------------------------------------------------------------

TARGET = np.array([1.0, -2.0, 3.0], np.float32)
OPTIMIZE_CASES = {
    "SGD": lambda m: m.SGD(learning_rate=0.1),
    "Adam": lambda m: m.Adam(learning_rate=0.3),
    "Adagrad": lambda m: m.Adagrad(learning_rate=1.0),
    "Adadelta": lambda m: m.Adadelta(epsilon=1e-2),
    "Adamax": lambda m: m.Adamax(learning_rate=0.5),
    "RMSprop": lambda m: m.RMSprop(learning_rate=0.3),
}


def _quadratic(lib):
    target = lib.asarray(TARGET) if lib is jnp else torch.from_numpy(TARGET)

    def feval(x):
        d = x - target
        return float((d * d).sum()), 2 * d

    return feval


@pytest.mark.parametrize("name", list(OPTIMIZE_CASES))
def test_optimize_on_a_quadratic_matches_jax_and_converges(name):
    jm, tm = OPTIMIZE_CASES[name](joptim), OPTIMIZE_CASES[name](toptim)
    jx, tx = jnp.zeros(3), torch.zeros(3)
    jf, tf = _quadratic(jnp), _quadratic(torch)
    for i in range(200):
        jx, jl = jm.optimize(jf, jx)
        tx, tl = tm.optimize(tf, tx)
        if i < 20:
            np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
            np.testing.assert_allclose(tl, jl, **TOL)
    assert tm.state["neval"] == jm.state["neval"] == 201
    assert float(((tx - torch.from_numpy(TARGET)) ** 2).sum()) < 1e-2


def _rosen(lib):
    def f(x):
        return (100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2).sum()

    if lib is jnp:
        g = jax.grad(f)
        return lambda x: (float(f(x)), g(x))

    def feval(x):
        x = x.detach().requires_grad_()
        y = f(x)
        (gx,) = torch.autograd.grad(y, x)
        return float(y), gx

    return feval


@pytest.mark.parametrize("line_search", [True, False])
def test_lbfgs_rosenbrock_iterates_match_jax(line_search):
    """LBFGS's iterates and loss history against the JAX LBFGS over its
    first call (up to 100 iterations), and convergence below 1e-2 (the
    JAX test's limit)
    after 20."""
    kw = dict(max_iter=100, learning_rate=0.5, line_search=line_search)
    jl, tl = joptim.LBFGS(**kw), toptim.LBFGS(**kw)
    jx, tx = jnp.zeros(4), torch.zeros(4)
    jf, tf = _rosen(jnp), _rosen(torch)
    for call in range(20):
        jx, jh = jl.optimize(jf, jx)
        tx, th = tl.optimize(tf, tx)
        if call == 0:
            # a trajectory: f32 rounding grows along it (a long step
            # without the line search takes f from 2.7 to 126; near the
            # optimum f is rounding itself)
            np.testing.assert_allclose(th, jh, rtol=TRAJ_RTOL)
            np.testing.assert_allclose(tx.numpy(), np.asarray(jx),
                                       rtol=TRAJ_RTOL, atol=1e-6)
    assert tl.state["neval"] == jl.state["neval"] == 21
    assert tf(tx)[0] < 1e-2
    assert jf(jx)[0] < 1e-2


def test_lbfgs_lswolfe_matches_jax():
    x0 = np.array([-1.2, 1.0, 0.3, -0.5], np.float32)
    jf, tf = _rosen(jnp), _rosen(torch)
    jx, tx = jnp.asarray(x0), torch.from_numpy(x0)
    f, g = jf(jx)
    want = joptim.LBFGS._lswolfe(jf, jx, 1.0, -g, f, g,
                                 float(jnp.vdot(g, -g)))
    f, g = tf(tx)
    got = toptim.LBFGS._lswolfe(tf, tx, 1.0, -g, f, g, float(g @ -g))
    assert got[4] == want[4]                       # evaluations
    np.testing.assert_allclose(got[0], want[0], **TOL)   # step
    np.testing.assert_allclose(got[1], want[1], **TOL)   # f
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), **TOL)


# ----------------------------------------------------------------------
# slots through save / load, pickling, the hyper-parameter string
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["Adagrad", "Adamax", "Adam"])
def test_slots_survive_save_and_load(tmp_path, name):
    method = {"Adagrad": lambda: toptim.Adagrad(0.05),
              "Adamax": lambda: toptim.Adamax(0.05),
              "Adam": lambda: toptim.Adam(0.05)}[name]()
    params, grads = _trees(2)
    p = jax.tree_util.tree_map(torch.from_numpy, params)
    x = p["w"]
    for _ in range(3):
        x, _ = method.optimize(lambda v: (float((v * v).sum()), 2 * v), x)
    path = str(tmp_path / "om")
    method.save(path)
    with pytest.raises(FileExistsError):
        method.save(path)
    back = toptim.OptimMethod.load(path, device="cpu")
    assert type(back) is type(method)
    assert back.state["neval"] == method.state["neval"] == 4
    for a, b in zip(tree_leaves(back._slots), tree_leaves(method._slots)):
        assert torch.equal(a, b)
    # the restored method continues exactly as the original
    y1, _ = method.optimize(lambda v: (float((v * v).sum()), 2 * v), x)
    y2, _ = back.optimize(lambda v: (float((v * v).sum()), 2 * v), x)
    assert torch.equal(y1, y2)
    assert "learning rate" in back.get_hyper_parameter()


def test_checkpointed_slots_resume(tmp_path):
    """Adagrad's accumulator checkpoints with the optimMethod leg and a
    resumed LocalOptimizer reuses it (tests/test_local_optimizer.py:180)."""
    ds = _linear_problem()
    model = tnn.Linear(6, 3, **CPU)
    opt = toptim.LocalOptimizer(model, ds, tnn.CrossEntropyCriterion(),
                                batch_size=8)
    opt.set_optim_method(toptim.Adagrad(0.05))
    opt.set_end_when(toptim.max_iteration(3))
    opt.set_checkpoint(str(tmp_path), toptim.several_iteration(3))
    opt.optimize()
    om = toptim.OptimMethod.load(str(tmp_path / "optimMethod.3"))
    assert isinstance(om, toptim.Adagrad)
    assert any(float(t.abs().max()) > 0 for t in tree_leaves(om._slots))
    opt2 = toptim.LocalOptimizer(tnn.Linear(6, 3, **CPU), ds,
                                 tnn.CrossEntropyCriterion(), batch_size=8)
    opt2.set_checkpoint(str(tmp_path), toptim.several_iteration(100))
    assert opt2.resume_from_checkpoint()
    assert opt2.optim_method.state["neval"] == 4
    opt2.set_end_when(toptim.max_iteration(4))
    opt2.optimize()
    assert opt2.optim_method.state["neval"] == 5


# ----------------------------------------------------------------------
# regularizers
# ----------------------------------------------------------------------

REGS = {"L1": lambda m: m.L1Regularizer(0.01),
        "L2": lambda m: m.L2Regularizer(0.1),
        "L1L2": lambda m: m.L1L2Regularizer(0.01, 0.1)}


@pytest.mark.parametrize("name", list(REGS))
def test_regularizer_penalty_and_gradient_match_jax(name):
    rng = np.random.RandomState(4)
    w = rng.randn(5, 4).astype(np.float32)
    w[0, 0] = 0.0   # |w|'s gradient at 0 is 0 on both sides
    jr, tr = REGS[name](jreg), REGS[name](treg)
    want, want_g = jax.value_and_grad(jr.loss)(jnp.asarray(w))
    tw = torch.from_numpy(w).requires_grad_()
    got = tr.loss(tw)
    (got_g,) = torch.autograd.grad(got, tw)
    np.testing.assert_allclose(float(got), float(want), **TOL)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **TOL)


def _reg_models():
    """The same regularized Sequential in both packages, with a nested
    container and a regularizer the walk cannot reach (inside a
    non-Container module it never enters)."""
    def build(nn, reg, **kw):
        inner = nn.Sequential(
            nn.Linear(5, 4, True, reg.L2Regularizer(0.05),
                      reg.L1Regularizer(0.02), **kw), nn.Tanh(**kw), **kw)
        return nn.Sequential(
            nn.Linear(6, 5, True, reg.L1L2Regularizer(0.01, 0.03), **kw),
            nn.Tanh(**kw), inner,
            nn.Linear(4, 3, True, None, reg.L2Regularizer(0.1), **kw), **kw)

    jm, tm = build(jnn, jreg), build(tnn, treg, **CPU)
    load_param_tree(tm, _np(jm.param_tree()))
    return jm, tm


def test_regularizer_walk_and_loss_match_jax():
    jm, tm = _reg_models()
    jp = list(jreg.collect_regularizer_paths(jm))
    tp = list(treg.collect_regularizer_paths(tm))
    assert [p for p, _ in tp] == [p for p, _ in jp]
    assert [type(r).__name__ for _, r in tp] == \
        [type(r).__name__ for _, r in jp]
    want = jreg.regularizer_loss(jm.param_tree(), jp)
    got = treg.regularizer_loss(tm.param_tree(), tp)
    np.testing.assert_allclose(float(got), float(want), **TOL)
    # a parameter-free tree and no regularizer give 0
    assert treg.regularizer_loss({}, []) == 0.0


def _linear_problem(n=8, seed=11, nan_row=None, classes=3):
    rng = np.random.RandomState(seed)
    xs = rng.randn(n, 6).astype(np.float32)
    if nan_row is not None:
        xs[nan_row, 2] = np.nan
    ys = rng.randint(1, classes + 1, size=n).astype(np.int32)
    return array([Sample(x, y) for x, y in zip(xs, ys)])


def _jlinear_problem(n=8, seed=11, classes=3):
    rng = np.random.RandomState(seed)
    xs = rng.randn(n, 6).astype(np.float32)
    ys = rng.randint(1, classes + 1, size=n).astype(np.int32)
    return jarray([JSample(x, y) for x, y in zip(xs, ys)])


def _trajectory(jm, tm, jmethod, tmethod, iters=6, n=16, batch=4):
    """``iters`` LocalOptimizer steps of each package from host seed 1;
    returns (port losses, JAX losses)."""
    out = []
    for m, pkg, data, crit, R, method in (
            (tm, toptim, _linear_problem(n), tnn.CrossEntropyCriterion(),
             RNG, tmethod),
            (jm, joptim, _jlinear_problem(n), jnn.CrossEntropyCriterion(),
             JRNG, jmethod)):
        losses = []

        def check(state, _l=losses, _pkg=pkg):
            if "loss" in state:
                _l.append(state["loss"])
            return _pkg.max_iteration(iters)(state)

        opt = pkg.LocalOptimizer(m, data, crit, batch_size=batch)
        opt.set_optim_method(method).set_end_when(pkg.Trigger(check))
        R().set_seed(1)
        opt.optimize()
        out.append(losses)
    return out


def test_regularized_trajectory_matches_jax():
    """Six LocalOptimizer steps of the regularized model: the logged loss
    carries the penalty, the gradient its gradient, as the JAX step."""
    jm, tm = _reg_models()
    got, want = _trajectory(jm, tm, joptim.SGD(0.1, momentum=0.9),
                            toptim.SGD(0.1, momentum=0.9))
    assert len(got) == len(want) == 6
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)
    _close_trees(param_tree_numpy(tm), _np(jm.param_tree()),
                 rtol=TRAJ_RTOL, atol=1e-6)
    # the penalty is in the logged loss: without regularizers it differs
    jm2, tm2 = _reg_models()
    for m in tm2.modules():
        m.w_regularizer = m.b_regularizer = None
    plain, _ = _trajectory(jm2, tm2, joptim.SGD(0.1, momentum=0.9),
                           toptim.SGD(0.1, momentum=0.9))
    assert got[0] > plain[0]


# ----------------------------------------------------------------------
# F7: set_scale_w / set_scale_b in LocalOptimizer
# ----------------------------------------------------------------------

def test_gradient_scale_trees_match_jax():
    jm = jnn.Sequential(jnn.Linear(6, 5), jnn.Tanh(), jnn.Linear(5, 3))
    tm = tnn.Sequential(tnn.Linear(6, 5, **CPU), tnn.Tanh(**CPU),
                        tnn.Linear(5, 3, **CPU))
    for m in (jm, tm):
        m.modules[2].set_scale_w(0.5) if m is jm else m[2].set_scale_w(0.5)
        (m.modules[0] if m is jm else m[0]).set_scale_b(2.0)
        m.set_scale_w(7.0)      # a Container's own scale reaches nothing
    assert tm.gradient_scale_tree() == jm.gradient_scale_tree()

    kw = dict(embed_dim=16, num_heads=2, num_layers=2, max_len=8)
    jlm, tlm = JTransformerLM(20, **kw), TransformerLM(20, **kw, **CPU)
    jlm.modules[1].set_scale_w(0.25)            # a block: a Container
    jlm.modules[2].modules[1].set_scale_w(0.5)  # its attention: not one
    jlm.modules[2].modules[1].set_scale_b(3.0)
    jlm.set_scale_w(1.5)                        # reaches "pos" only
    tlm[1].set_scale_w(0.25)
    tlm[2][1].set_scale_w(0.5)
    tlm[2][1].set_scale_b(3.0)
    tlm.set_scale_w(1.5)
    assert tlm.gradient_scale_tree() == jlm.gradient_scale_tree()


def test_scale_w_one_step_probe_matches_jax():
    """The F7 probe: Linear(6, 3) with set_scale_w(0.5), one SGD(0.1)
    step of each LocalOptimizer on the same 8 samples.  Before the fix
    the port's update was exactly twice the JAX one."""
    jm, tm = jnn.Linear(6, 3), tnn.Linear(6, 3, **CPU)
    load_param_tree(tm, _np(jm.param_tree()))
    w0 = np.asarray(jm.param_tree()["weight"]).copy()
    jm.set_scale_w(0.5)
    tm.set_scale_w(0.5)
    got, want = _trajectory(jm, tm, joptim.SGD(0.1), toptim.SGD(0.1),
                            iters=1, n=8, batch=8)
    np.testing.assert_allclose(got, want, **TOL)
    dj = np.asarray(jm.param_tree()["weight"]) - w0
    dt = tm.weight.detach().numpy() - w0
    np.testing.assert_allclose(dt, dj, **TOL)


def test_scale_w_and_b_trajectory_matches_jax():
    jm = jnn.Sequential(jnn.Linear(6, 5), jnn.Tanh(), jnn.Linear(5, 3))
    tm = tnn.Sequential(tnn.Linear(6, 5, **CPU), tnn.Tanh(**CPU),
                        tnn.Linear(5, 3, **CPU))
    load_param_tree(tm, _np(jm.param_tree()))
    for m in (jm.modules[0], jm.modules[2], tm[0], tm[2]):
        m.set_scale_w(0.5).set_scale_b(2.0)
    got, want = _trajectory(jm, tm, joptim.SGD(0.1, momentum=0.9),
                            toptim.SGD(0.1, momentum=0.9))
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)
    _close_trees(param_tree_numpy(tm), _np(jm.param_tree()),
                 rtol=TRAJ_RTOL, atol=1e-6)


# ----------------------------------------------------------------------
# the torch.optim bridge
# ----------------------------------------------------------------------

@pytest.mark.parametrize("which", ["sgd", "adam"])
def test_bridge_steps_match_optax_method(which):
    lr = 0.05
    jm = joptim.OptaxMethod({"sgd": optax.sgd, "adam": optax.adam}[which],
                            lr)
    tm = toptim.TorchOptimMethod(
        {"sgd": torch.optim.SGD, "adam": torch.optim.Adam}[which], lr=lr)
    _both(jm, tm, 1.0)


@pytest.mark.parametrize("which", ["sgd", "adam"])
def test_bridge_trajectory_matches_optax_method(which):
    jm = jnn.Sequential(jnn.Linear(6, 5), jnn.Tanh(), jnn.Linear(5, 3))
    tm = tnn.Sequential(tnn.Linear(6, 5, **CPU), tnn.Tanh(**CPU),
                        tnn.Linear(5, 3, **CPU))
    load_param_tree(tm, _np(jm.param_tree()))
    got, want = _trajectory(
        jm, tm,
        joptim.OptaxMethod({"sgd": optax.sgd, "adam": optax.adam}[which],
                           3e-2),
        toptim.TorchOptimMethod({"sgd": torch.optim.SGD,
                                 "adam": torch.optim.Adam}[which], lr=3e-2))
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)
    _close_trees(param_tree_numpy(tm), _np(jm.param_tree()),
                 rtol=TRAJ_RTOL, atol=1e-6)


def test_bridge_learning_rate_multiplies_the_update():
    params, grads = _trees(1, 1)
    p = jax.tree_util.tree_map(torch.from_numpy, params)
    g = jax.tree_util.tree_map(torch.from_numpy, grads[0])
    m = toptim.TorchOptimMethod(torch.optim.SGD, lr=0.1, learning_rate=0.5)
    new, _ = m.step(g, p, m.init_state(p), m.get_current_lr())
    for a, b, c in zip(tree_leaves(new), tree_leaves(p), tree_leaves(g)):
        torch.testing.assert_close(a, b - 0.05 * c)


def test_bridge_pickles_through_its_factory_and_refuses_a_prebuilt():
    m = toptim.TorchOptimMethod(torch.optim.Adam, lr=1e-3, betas=(0.8, 0.9))
    params, grads = _trees(3, 2)
    p = jax.tree_util.tree_map(torch.from_numpy, params)
    slots = m.init_state(p)
    for g in grads:
        p, slots = m.step(jax.tree_util.tree_map(torch.from_numpy, g), p,
                          slots, 1.0)
    m._slots = slots
    back = pickle.loads(pickle.dumps(m))
    assert back._opt is None and back._factory_kwargs["betas"] == (0.8, 0.9)
    g = jax.tree_util.tree_map(torch.from_numpy, _trees(9, 1)[1][0])
    a, _ = m.step(g, p, slots, 1.0)
    b, _ = back.step(g, p, back._slots, 1.0)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)

    prebuilt = torch.optim.SGD([torch.zeros(2, requires_grad=True)], lr=0.1)
    with pytest.raises(TypeError, match="factory"):
        pickle.dumps(toptim.TorchOptimMethod(opt=prebuilt))
    with pytest.raises(ValueError):
        toptim.TorchOptimMethod()
    with pytest.raises(ValueError):
        toptim.TorchOptimMethod(torch.optim.SGD, opt=prebuilt, lr=0.1)


def test_bridge_prebuilt_optimizer_steps():
    params, grads = _trees(4, 2)
    prebuilt = torch.optim.SGD([torch.zeros(5, requires_grad=True)], lr=0.1,
                               momentum=0.9)
    got = _run_steps(toptim.TorchOptimMethod(opt=prebuilt), params, grads,
                     1.0, torch.from_numpy)
    want = _run_steps(toptim.SGD(0.1, momentum=0.9, dampening=0.0), params,
                      grads, 0.1, torch.from_numpy)
    _close_trees(got, {k: np.asarray(v) if not isinstance(v, dict) else
                       {kk: np.asarray(vv) for kk, vv in v.items()}
                       for k, v in want.items()})


@pytest.mark.parametrize("bad_step", [1, 2])
def test_bridge_skipped_step_leaves_its_state(bad_step):
    """A NaN batch at step ``bad_step``: the guard skips it, and the
    bridge's state (its step count and moments) is what it was before:
    the run equals the run of the good steps alone."""
    def run(batches):
        model = tnn.Linear(6, 3, **CPU,
                           generator=torch.Generator().manual_seed(0))
        xs = []
        for b, nan in enumerate(batches):
            ds = _linear_problem(8, seed=20 + b, nan_row=3 if nan else None)
            xs += list(ds.data(train=False))
        opt = toptim.LocalOptimizer(model, array(xs),
                                    tnn.CrossEntropyCriterion(),
                                    batch_size=8)
        opt.set_optim_method(toptim.TorchOptimMethod(torch.optim.Adam,
                                                     lr=0.05))
        opt.set_end_when(toptim.max_iteration(len(batches)))
        RNG().set_seed(1)
        opt.optimize()
        return model, opt

    batches = [False, False, False]
    batches[bad_step] = True
    model, opt = run(batches)
    assert opt.skipped_steps == 1
    slots = opt.optim_method._slots
    assert int(slots["count"]) == 2
    assert not opt.optim_method._opt.state   # the slots hold the state
    # the same good batches without the bad one, in order
    ref_model, ref_opt = run([False, False])
    if bad_step == 2:
        for a, b in zip(tree_leaves(slots), tree_leaves(ref_opt.optim_method
                                                        ._slots)):
            assert torch.equal(a, b)
        for a, b in zip(model.parameters(), ref_model.parameters()):
            assert torch.equal(a, b)
    assert all(torch.isfinite(t).all() for t in tree_leaves(slots))


# ----------------------------------------------------------------------
# layers: LookupTable's max norm, the JAX signatures
# ----------------------------------------------------------------------

@pytest.mark.parametrize("norm_type", [2.0, 1.0])
def test_lookup_table_max_norm_matches_jax(norm_type):
    jm = jnn.LookupTable(10, 6, max_norm=1.5, norm_type=norm_type)
    tm = tnn.LookupTable(10, 6, max_norm=1.5, norm_type=norm_type, **CPU)
    load_param_tree(tm, _np(jm.param_tree()))
    ids = np.array([[1, 3, 10, 3], [2, 2, 7, 9]], np.int32)
    out = np.random.RandomState(0).randn(2, 4, 6).astype(np.float32)

    def jloss(p):
        y, _ = jm.apply_fn(p, jm.buffer_tree(), jnp.asarray(ids), True, None)
        return jnp.sum(y * out), y

    (_, want), want_g = jax.value_and_grad(jloss, has_aux=True)(
        jm.param_tree())
    y = tm.apply_fn(tm.param_tree(), torch.from_numpy(ids))
    (got_g,) = torch.autograd.grad((y * torch.from_numpy(out)).sum(),
                                   [tm.weight])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_g.numpy(),
                               np.asarray(want_g["weight"]), **TOL)
    norms = np.linalg.norm(y.detach().numpy().reshape(-1, 6), ord=norm_type,
                           axis=1)
    assert norms.max() <= 1.5 + 1e-5


def test_layer_signatures_take_the_jax_positions():
    r = treg.L2Regularizer(0.1)
    lin = tnn.Linear(4, 3, False, r, None, **CPU)
    assert lin.w_regularizer is r and not lin.with_bias
    lt = tnn.LookupTable(10, 4, 0, 2.0, 1.0, True, r, **CPU)
    assert (lt.max_norm, lt.norm_type, lt.should_scale_grad_by_freq,
            lt.w_regularizer) == (2.0, 1.0, True, r)
    # with_bias is the 13th positional argument in both packages
    args = (3, 4, 3, 3, 1, 1, 1, 1, 1, True, r, None, False)
    jc, tc = jnn.SpatialConvolution(*args), tnn.SpatialConvolution(*args,
                                                                   **CPU)
    assert set(tc.param_tree()) == set(jc.param_tree()) == {"weight"}
    assert tc.w_regularizer is r and tc.propagate_back
    with pytest.raises(TypeError):
        tnn.Linear(4, 3, True, None, None, "cpu")   # device is a keyword


# ----------------------------------------------------------------------
# fsspec (tests/test_file_io_backends.py's memory:// cases), rdd
# ----------------------------------------------------------------------

def _tiny():
    return tnn.Sequential(tnn.Linear(3, 4, **CPU), tnn.Tanh(**CPU))


class TestMemoryScheme:
    def test_save_load_roundtrip(self):
        from bigdl_tpu_torch.nn.module import load_module

        m = _tiny()
        path = "memory://port_ckpt/model_a"
        m.save(path, overwrite=True)
        loaded = load_module(path, device="cpu")
        np.testing.assert_allclose(loaded.get_parameters()[0].numpy(),
                                   m.get_parameters()[0].numpy())

    def test_overwrite_contract(self):
        m = _tiny()
        path = "memory://port_ckpt/model_b"
        m.save(path, overwrite=True)
        with pytest.raises(FileExistsError):
            m.save(path, overwrite=False)

    def test_listdir_isdir_join(self):
        m = _tiny()
        file_io.save(m.param_tree(), "memory://port_ckpt2/model.3",
                     overwrite=True)
        file_io.save(m.param_tree(), "memory://port_ckpt2/model.12",
                     overwrite=True)
        assert file_io.isdir("memory://port_ckpt2")
        assert {"model.3", "model.12"} <= set(
            file_io.listdir("memory://port_ckpt2"))
        assert file_io.join("memory://port_ckpt2", "x") == \
            "memory://port_ckpt2/x"

    def test_training_checkpoints_to_memory_scheme(self):
        from bigdl_tpu_torch.resilience.checkpoint import \
            verify_and_load_latest

        model = tnn.Sequential(tnn.Linear(6, 3, **CPU),
                               tnn.LogSoftMax(**CPU))
        opt = toptim.LocalOptimizer(model, _linear_problem(32),
                                    tnn.ClassNLLCriterion(), batch_size=16)
        opt.set_optim_method(toptim.SGD(0.1))
        opt.set_end_when(toptim.max_iteration(4))
        opt.set_checkpoint("memory://port_run1",
                           toptim.several_iteration(2))
        opt.optimize()
        names = set(file_io.listdir("memory://port_run1"))
        assert {"model.2", "model.4", "optimMethod.4"} <= names
        leg, path = verify_and_load_latest("memory://port_run1", "model")
        assert path == "memory://port_run1/model.4"
        assert torch.equal(leg["params"]["0"]["weight"],
                           model[0].weight.detach())

    def test_unknown_protocol_raises_like_jax(self):
        from bigdl_tpu.utils import file_io as jfile_io

        with pytest.raises(ValueError, match="register") as got:
            file_io.filesystem_for("nosuchproto://x/y")
        with pytest.raises(ValueError, match="register") as want:
            jfile_io.filesystem_for("nosuchproto://x/y")
        assert str(got.value) == str(want.value)


def test_rdd_is_a_sharded_local_array():
    from bigdl_tpu.dataset.dataset import rdd as jrdd

    samples = [Sample(np.array([i], np.float32), np.array([i]))
               for i in range(10)]
    ds = rdd(samples, partition_num=4)
    assert isinstance(ds, ShardedDataSet) and ds.partition_num == 4
    assert ds.size() == jrdd(list(range(10)), 4).size() == 10
    JRNG().set_seed(3)
    RNG().set_seed(3)
    jds = jrdd([JSample(np.array([i], np.float32), np.array([i]))
                for i in range(10)], 4)
    jds.shuffle()
    ds.shuffle()
    got = [int(s.feature[0]) for s in ds.data(train=False)]
    want = [int(np.asarray(s.feature)[0]) for s in jds.data(train=False)]
    assert got == want


# ----------------------------------------------------------------------
# the training loop: train_more, straggler knobs, the exports
# ----------------------------------------------------------------------

def test_train_more_continues_where_it_stopped():
    """3 iterations, then ``train_more(2)``: the state table carries
    ``neval`` on (6 after 5 steps) and the run is the JAX package's
    (which also starts the epoch's batches anew on re-entry)."""
    jm = jnn.Linear(6, 3)
    tm = tnn.Linear(6, 3, **CPU)
    load_param_tree(tm, _np(jm.param_tree()))
    for m, pkg, data, crit, R in (
            (tm, toptim, _linear_problem(16), tnn.CrossEntropyCriterion(),
             RNG),
            (jm, joptim, _jlinear_problem(16), jnn.CrossEntropyCriterion(),
             JRNG)):
        opt = pkg.LocalOptimizer(m, data, crit, batch_size=4)
        opt.set_optim_method(pkg.SGD(0.1, momentum=0.9))
        opt.set_end_when(pkg.max_iteration(3))
        R().set_seed(1)
        opt.optimize()
        opt.train_more(2)
        assert opt.optim_method.state["neval"] == 6
        with pytest.raises(ValueError):
            opt.train_more(0)
    _close_trees(param_tree_numpy(tm), _np(jm.param_tree()),
                 rtol=TRAJ_RTOL, atol=1e-6)


def test_drop_module_property_is_kept_and_warns(caplog):
    opt = toptim.LocalOptimizer(tnn.Linear(6, 3, **CPU), _linear_problem(),
                                tnn.CrossEntropyCriterion(), batch_size=8)
    assert opt.set_drop_module_property(0.1, 0.2, 50, 30) is opt
    assert (opt.drop_percentage, opt.max_drop_percentage,
            opt.compute_threshold_batchsize, opt._drop_warmup) == \
        (0.1, 0.2, 50, 30)
    opt.set_end_when(toptim.max_iteration(1))
    with caplog.at_level(logging.WARNING, logger="bigdl_tpu_torch"):
        opt.optimize()
    assert "no straggler to drop" in caplog.text


def test_optim_exports_are_the_jax_packages():
    """Every name the JAX ``optim`` package exports, the distributed
    optimizer and validator included."""
    want = {n for n in dir(joptim) if not n.startswith("_")
            and not isinstance(getattr(joptim, n), type(joptim))}
    assert {"DistriOptimizer", "DistriValidator"} <= want
    missing = sorted(n for n in want if not hasattr(toptim, n))
    assert missing == []
