"""The port's layer zoo (bigdl_tpu_torch.nn) against the JAX package's, in
f32 on the CPU: one case per class of the JAX package's activations,
shape_ops, table_ops, containers, linear, normalization and dropout
modules.  Each case carries the JAX layer's weights across with
``interop.jax_params.load_param_tree``, runs both layers' Torch-style
verbs on the same numpy inputs made from a seed — ``forward``, then
``backward`` of a seeded output gradient — and holds the port's output,
input gradient and accumulated parameter gradients against the JAX
layer's.

The inputs are those of ``tests/test_gradient_value_sweep.py``, which
holds the JAX layers against float64 finite differences; the semantic
cases mirror ``tests/test_layers_oracle.py`` and
``tests/test_layer_zoo_sweep.py``.  Where those hold the JAX package
against a float64 torch oracle, these hold the port against the JAX
package in f32 (JAX runs without x64 here), at ``TOL`` unless a case
states a looser limit.
"""
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as jnn
from bigdl_tpu.utils.table import Table as JTable
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.interop import load_param_tree
from bigdl_tpu_torch.utils.table import Table as PTable

# The suite runs in several processes at once: one intra-op thread each
# keeps these small tensors from crowding the timing-sensitive tests.
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
CPU = dict(device="cpu")


class T:
    """A Table of numpy inputs, converted to either package's Table."""

    def __init__(self, *items):
        self.items = items


def to_jax(x):
    if isinstance(x, T):
        return JTable(*(to_jax(v) for v in x.items))
    return jnp.asarray(x)


def to_port(x):
    if isinstance(x, T):
        return PTable(*(to_port(v) for v in x.items))
    return torch.as_tensor(np.array(x))


def leaves(x):
    """numpy leaves of either package's activity, in key order."""
    if isinstance(x, (JTable, PTable)):
        return [leaf for k in sorted(x.keys()) for leaf in leaves(x[k])]
    if isinstance(x, torch.Tensor):
        return [x.detach().float().numpy()]
    return [np.asarray(x, np.float32)]


def flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = (v.detach().float().numpy()
                               if isinstance(v, torch.Tensor)
                               else np.asarray(v, np.float32))
    return out


def seeded_like(out, seed=0):
    """A seeded output gradient with each output leaf's shape."""
    rng = np.random.RandomState(seed)
    if isinstance(out, (JTable, PTable)):
        return T(*(seeded_like(out[k], seed + i)
                   for i, k in enumerate(sorted(out.keys()))))
    return rng.standard_normal(np.asarray(out).shape).astype(np.float32)


def run_pair(jm, pm, inp, train=False, tol=TOL):
    """Both layers' forward and backward on ``inp``; every output, input
    gradient and parameter gradient held at ``tol``."""
    load_param_tree(pm, jax.tree_util.tree_map(np.asarray, jm.param_tree()))
    if train:
        jm.training()
        pm.train()
    else:
        jm.evaluate()
        pm.evaluate()
    xj, xp = to_jax(inp), to_port(inp)
    want = jm.forward(xj)
    got = pm.forward(xp)
    for g, w in zip(leaves(got), leaves(want), strict=True):
        np.testing.assert_allclose(g, w, **tol)
    go = seeded_like(want)
    jm.zero_grad_parameters()
    pm.zero_grad_parameters()
    gi_want = jm.backward(xj, to_jax(go))
    gi_got = pm.backward(xp, to_port(go))
    for g, w in zip(leaves(gi_got), leaves(gi_want), strict=True):
        np.testing.assert_allclose(g, w, **tol)
    gp_want = flat_tree(jax.tree_util.tree_map(np.asarray, jm.grad_tree()))
    gp_got = flat_tree(pm.grad_tree())
    assert sorted(gp_got) == sorted(gp_want)
    for k, w in gp_want.items():
        np.testing.assert_allclose(gp_got[k], w, err_msg=k, **tol)
    return got, want


R = np.random.RandomState(7)
X = R.randn(3, 6).astype(np.float32)
X2 = R.randn(3, 6).astype(np.float32)
XP = (R.rand(3, 6) + 0.2).astype(np.float32)
X3 = R.randn(2, 5, 6).astype(np.float32)
X4 = R.randn(2, 3, 8, 8).astype(np.float32)
X134 = R.randn(3, 1, 4).astype(np.float32)
X234 = R.randn(2, 3, 4).astype(np.float32)
NHWC = R.randn(2, 6, 6, 3).astype(np.float32)
GATE = (R.rand(3, 2) + 0.1).astype(np.float32)
MM_A = R.randn(2, 3, 4).astype(np.float32)
MM_B = R.randn(2, 4, 5).astype(np.float32)
MV_V = R.randn(2, 5).astype(np.float32)
BI_A = R.randn(3, 5).astype(np.float32)
BI_B = R.randn(3, 4).astype(np.float32)


def both(name, *args, **kw):
    """(JAX layer, port layer) of class ``name`` from the same args."""
    return (lambda: getattr(jnn, name)(*args, **kw),
            lambda: getattr(tnn, name)(*args, **kw, **CPU))


def wrapped(name, *children):
    """A container of class ``name`` over children built from
    (class name, args) pairs."""
    return (lambda: getattr(jnn, name)(*(getattr(jnn, c)(*a)
                                         for c, a in children)),
            lambda: getattr(tnn, name)(*(getattr(tnn, c)(*a, **CPU)
                                         for c, a in children), **CPU))


# name -> ((make JAX layer, make port layer), input, run_pair kwargs)
ZOO_CASES = {
    # activations
    "Abs": (both("Abs"), XP, {}),
    "Clamp": (both("Clamp", -0.5, 0.5), X, {}),
    "ELU": (both("ELU", 0.7), X, {}),
    "Exp": (both("Exp"), X, {}),
    "HardShrink": (both("HardShrink", 0.5), X, {}),
    "HardTanh": (both("HardTanh", -0.5, 0.5), X, {}),
    "LeakyReLU": (both("LeakyReLU", 0.1), X, {}),
    "Log": (both("Log"), XP, {}),
    "LogSigmoid": (both("LogSigmoid"), X, {}),
    "LogSoftMax": (both("LogSoftMax"), X, {}),
    "Max": (both("Max", 2), X, {}),
    "Mean": (both("Mean", 2), X, {}),
    "Min": (both("Min", 2), X, {}),
    "PReLU": (both("PReLU"), X, {}),
    "Power": (both("Power", 2.0, 1.5, 0.1), XP, {}),
    "RReLU": (both("RReLU", 0.2, 0.4), X, {}),   # eval: the fixed slope
    "ReLU": (both("ReLU"), X, {}),
    "ReLU6": (both("ReLU6"), 4 * X, {}),
    "Sigmoid": (both("Sigmoid"), X, {}),
    "SoftMax": (both("SoftMax"), X, {}),
    "SoftMin": (both("SoftMin"), X, {}),
    "SoftPlus": (both("SoftPlus"), X, {}),
    "SoftShrink": (both("SoftShrink", 0.5), X, {}),
    "SoftSign": (both("SoftSign"), X, {}),
    "Sqrt": (both("Sqrt"), XP, {}),
    "Square": (both("Square"), X, {}),
    "Sum": (both("Sum", 2, size_average=True), X, {}),
    "Tanh": (both("Tanh"), X, {}),
    "TanhShrink": (both("TanhShrink"), X, {}),
    "Threshold": (both("Threshold", 0.2, -1.0), X, {}),
    # shape ops
    "Contiguous": (both("Contiguous"), X, {}),
    "CosineDistance": (both("CosineDistance"), T(X, X2), {}),
    "DotProduct": (both("DotProduct"), T(X, X2), {}),
    "FlattenTable": (both("FlattenTable"), T(X, T(X2, XP)), {}),
    "GradientReversal": (both("GradientReversal", 0.7), X, {}),
    "Index": (both("Index", 1),
              T(X, np.array([2.0, 1.0], np.float32)), {}),
    "InferReshape": (both("InferReshape", [4, 6]), X234, {}),
    "JoinTable": (both("JoinTable", 2, 2), T(X, X2), {}),
    "MaskedSelect": (both("MaskedSelect"),
                     T(X, (X2 > 0).astype(np.float32)), {}),
    "MixtureTable": (both("MixtureTable"), T(GATE[:, :2], T(X, X2)), {}),
    "Narrow": (both("Narrow", 2, 2, 3), X, {}),
    "NarrowTable": (both("NarrowTable", 1, 2), T(X, X2, XP), {}),
    "Pack": (both("Pack", 2), T(X, X2), {}),
    "Padding": (both("Padding", 2, -2, 2, 0.5), X, {}),
    "PairwiseDistance": (both("PairwiseDistance"), T(X, X2), {}),
    "Replicate": (both("Replicate", 3, 2), X, {}),
    "Reshape": (both("Reshape", [12]), X234, {}),
    "Reverse": (both("Reverse", 2), X, {}),
    "Scale": (both("Scale", [1, 6]), X, {}),
    "Select": (both("Select", 2, -1), X, {}),
    "SelectTable": (both("SelectTable", 2), T(X, X2), {}),
    "SpatialZeroPadding": (both("SpatialZeroPadding", 1, 2, 0, 1), X4, {}),
    "SplitTable": (both("SplitTable", 2), X3, {}),
    "Squeeze": (both("Squeeze", 2), X134, {}),
    "Transpose": (both("Transpose", [(2, 3), (1, 2)]), X3, {}),
    "Unsqueeze": (both("Unsqueeze", 2), X, {}),
    "View": (both("View", 12), X234, {}),
    # table ops
    "CAddTable": (both("CAddTable"), T(X, X2), {}),
    "CDivTable": (both("CDivTable"), T(XP, XP + 0.5), {}),
    "CMaxTable": (both("CMaxTable"), T(X, X2), {}),
    "CMinTable": (both("CMinTable"), T(X, X2), {}),
    "CMulTable": (both("CMulTable"), T(X, X2), {}),
    "CSubTable": (both("CSubTable"), T(X, X2), {}),
    # containers
    "Bottle": (wrapped("Bottle", ("Linear", (6, 4))), X3, {}),
    "Concat": ((lambda: jnn.Concat(2, jnn.Linear(6, 4), jnn.Linear(6, 3)),
                lambda: tnn.Concat(2, tnn.Linear(6, 4, **CPU),
                                   tnn.Linear(6, 3, **CPU), **CPU)), X, {}),
    "ConcatTable": (wrapped("ConcatTable", ("Linear", (6, 4)),
                            ("Tanh", ())), X, {}),
    "Echo": (both("Echo"), X, {}),
    "Identity": (both("Identity"), X, {}),
    "MapTable": (wrapped("MapTable", ("Linear", (6, 4))), T(X, X2), {}),
    "ParallelTable": (wrapped("ParallelTable", ("Linear", (6, 4)),
                              ("Tanh", ())), T(X, X2), {}),
    "Sequential": (wrapped("Sequential", ("Linear", (6, 4)), ("Tanh", ()),
                           ("Linear", (4, 2))), X, {}),
    # linear
    "Add": (both("Add", 6), X, {}),
    "AddConstant": (both("AddConstant", 2.5), X, {}),
    "Bilinear": (both("Bilinear", 5, 4, 3), T(BI_A, BI_B), {}),
    "CAdd": (both("CAdd", [6]), X, {}),
    "CMul": (both("CMul", [6]), X, {}),
    "Cosine": (both("Cosine", 6, 4), X, {}),
    "Euclidean": (both("Euclidean", 6, 3), X, {}),
    "Linear": (both("Linear", 6, 4), X, {}),
    "LookupTable": (both("LookupTable", 10, 4),
                    np.array([[1., 3.], [2., 9.]], np.float32), {}),
    "MM": (both("MM"), T(MM_A, MM_B), {}),
    "MV": (both("MV"), T(MM_B, MV_V), {}),
    "Mul": (both("Mul"), X, {}),
    "MulConstant": (both("MulConstant", 2.5), X, {}),
    # normalization
    "BatchNormalization": (both("BatchNormalization", 6), X,
                           {"train": True}),
    "ImageNormalize": (both("ImageNormalize", (0.4, 0.5, 0.6),
                            (0.2, 0.25, 0.3)), NHWC, {}),
    "L1Penalty": (both("L1Penalty", 0.3), X, {"train": True}),
    "LayerNorm": (both("LayerNorm", 6), X, {}),
    "Normalize": (both("Normalize", 2.0), X, {}),
    "RMSNorm": (both("RMSNorm", 6), X, {}),
    "SpatialBatchNormalization": (both("SpatialBatchNormalization", 3), X4,
                                  {"train": True}),
    "SpatialContrastiveNormalization": (
        both("SpatialContrastiveNormalization", 3), X4, {}),
    "SpatialCrossMapLRN": (both("SpatialCrossMapLRN"), X4, {}),
    "SpatialDivisiveNormalization": (
        both("SpatialDivisiveNormalization", 3), X4, {}),
    "SpatialSubtractiveNormalization": (
        both("SpatialSubtractiveNormalization", 3), X4, {}),
    # dropout: eval is the identity; training is held in
    # tests/test_torch_dropout.py (the two packages' masks differ)
    "Dropout": (both("Dropout", 0.5), X, {}),
}

#: the JAX package's modules whose classes this file covers
ZOO_MODULES = ("activations", "shape_ops", "table_ops", "containers",
               "linear", "normalization", "dropout")


@pytest.mark.parametrize("name", sorted(ZOO_CASES))
def test_port_layer_matches_jax(name):
    (make_j, make_p), inp, kw = ZOO_CASES[name]
    run_pair(make_j(), make_p(), inp, **kw)


def jax_classes(module_name: str, base):
    import importlib

    mod = importlib.import_module(f"bigdl_tpu.nn.{module_name}")
    return sorted(n for n, c in vars(mod).items()
                  if inspect.isclass(c) and c.__module__ == mod.__name__
                  and issubclass(c, base) and not n.startswith("_"))


def test_every_zoo_class_has_a_port_case():
    from bigdl_tpu.nn.module import AbstractModule

    names = [n for m in ZOO_MODULES for n in jax_classes(m, AbstractModule)]
    missing = sorted(set(names) - set(ZOO_CASES))
    assert not missing, f"no port case for {missing}"
    assert all(hasattr(tnn, n) for n in names)
    assert len(names) == 96


# --------------------------------------------------------------------------
# semantics the zoo's one-case sweep does not reach (test_layers_oracle.py,
# test_layer_zoo_sweep.py)
# --------------------------------------------------------------------------

def test_sum_dims_batch_mode_and_squeeze():
    for args, kw, x in (((1,), {}, X), ((2,), {}, X), ((-1,), {}, X4),
                        ((1,), dict(n_input_dims=1), X),
                        ((2,), dict(squeeze=False), X)):
        run_pair(jnn.Sum(*args, **kw), tnn.Sum(*args, **kw, **CPU), x)
    assert tnn.Sum(2, squeeze=False, **CPU).forward(
        torch.as_tensor(X)).shape == (3, 1)


@pytest.mark.parametrize("args,kw", [((3,), {}), ((-1,), dict(n_input_dims=1))])
def test_sum_past_the_rank_raises_like_the_reference(args, kw):
    # Sum.scala resolves a negative dim and then applies the batch
    # shift; past the rank its require() throws, and so do both layers
    with pytest.raises(ValueError):
        jnn.Sum(*args, **kw).forward(jnp.asarray(X))
    with pytest.raises(ValueError):
        tnn.Sum(*args, **kw, **CPU).forward(torch.as_tensor(X))


def test_prelu_channel_axis():
    """Channel axis of PReLU.scala:86: 1 for NCHW, 0 for CHW."""
    for x in (np.full((4, 8, 8), -1.0, np.float32),
              np.full((2, 4, 8, 8), -2.0, np.float32)):
        run_pair(jnn.PReLU(4), tnn.PReLU(4, **CPU), x)
    out = tnn.PReLU(4, **CPU).forward(torch.full((4, 2, 2), -1.0))
    np.testing.assert_allclose(out.detach().numpy(), -0.25)


def test_rrelu_training_slopes_lie_in_range_and_backward_reuses_them():
    m = tnn.RReLU(0.2, 0.4, **CPU).train()
    x = torch.as_tensor(X)
    y = m.forward(x)
    neg = X < 0
    ratio = y.detach().numpy()[neg] / X[neg]
    assert np.all(ratio >= 0.2 - 1e-6) and np.all(ratio <= 0.4 + 1e-6)
    gi = m.update_grad_input(x, torch.ones_like(y))     # a replay
    np.testing.assert_allclose(gi.numpy()[neg], ratio, rtol=1e-6)
    m.evaluate()
    run_pair(jnn.RReLU(0.2, 0.4), m, X)


def test_transpose_narrow_select_return_views():
    x = torch.as_tensor(X3)
    for m in (tnn.Transpose([(2, 3)], **CPU), tnn.Narrow(3, 2, 3, **CPU),
              tnn.Select(2, 2, **CPU)):
        y = m.forward(x)
        assert y.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()
    assert not tnn.Transpose([(2, 3)], **CPU).forward(x).is_contiguous()


def test_narrow_negative_length_and_select_negative_index():
    run_pair(jnn.Narrow(2, 2, -2), tnn.Narrow(2, 2, -2, **CPU), X)
    run_pair(jnn.Select(-1, 1), tnn.Select(-1, 1, **CPU), X)


def test_gradient_reversal_and_l1penalty_spec():
    go = torch.as_tensor(X2)
    m = tnn.GradientReversal(0.7, **CPU)
    x = torch.as_tensor(X)
    m.forward(x)
    np.testing.assert_allclose(m.backward(x, go).numpy(), -0.7 * X2,
                               atol=1e-6)
    m = tnn.L1Penalty(0.3, **CPU).train()
    m.forward(x)
    np.testing.assert_allclose(m.backward(x, go).numpy(),
                               X2 + 0.3 * np.sign(X), atol=1e-6)


def test_subtractive_normalization_of_a_constant_image_is_zero():
    y = tnn.SpatialSubtractiveNormalization(3, **CPU).forward(
        torch.ones(1, 3, 8, 8))
    assert float(y.abs().max()) < 1e-4


def test_table_layers_on_table_activities():
    nt = tnn.NarrowTable(2, 2, **CPU).forward(to_port(T(X, XP, X4)))
    assert nt.length() == 2 and tuple(nt[1].shape) == XP.shape
    idx = tnn.Index(1, **CPU).forward(to_port(T(X, np.array([2., 1.]))))
    np.testing.assert_allclose(idx.detach().numpy(), X[[1, 0]])
    sel = tnn.MaskedSelect(**CPU).forward(to_port(T(X, (X > 0) * 1.0)))
    np.testing.assert_allclose(sel.detach().numpy(), X[X > 0])


def test_echo_prints_the_shape(capsys):
    tnn.Echo(**CPU).set_name("probe").forward(torch.as_tensor(X))
    assert "probe shape: (3, 6)" in capsys.readouterr().out
