"""The port's Torch-style module API against the JAX package's, in f32 on
the CPU: the verbs (forward, backward, update_grad_input,
acc_grad_parameters, zero_grad_parameters, update_parameters), the
gradient scale, flat parameters, weights, save and load, init methods,
timing and traversal, ``Engine``, ``utils.util``, ``DirectedGraph``
(mirroring ``tests/test_directed_graph.py``), ``predict`` (the
single-device half of ``tests/test_predictor.py``) and the gradient
checker.  Weights go across with ``interop.jax_params.load_param_tree``;
inputs are numpy arrays made from a seed; limits are ``TOL``.
"""
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as jnn
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.interop import load_param_tree
from bigdl_tpu_torch.nn.module import load_module

from test_torch_layer_zoo import flat_tree

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
CPU = dict(device="cpu")
R = np.random.RandomState(3)
X = R.randn(4, 6).astype(np.float32)
GO = R.randn(4, 2).astype(np.float32)


def mlp_pair():
    jm = jnn.Sequential(jnn.Linear(6, 5), jnn.Tanh(), jnn.Linear(5, 2))
    pm = tnn.Sequential(tnn.Linear(6, 5, **CPU), tnn.Tanh(**CPU),
                        tnn.Linear(5, 2, **CPU))
    load_param_tree(pm, jax.tree_util.tree_map(np.asarray, jm.param_tree()))
    return jm, pm


def assert_trees_close(got, want, **tol):
    got = flat_tree(got)
    want = flat_tree(jax.tree_util.tree_map(np.asarray, want))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                   **(tol or TOL))


def test_verbs_step_matches_jax():
    jm, pm = mlp_pair()
    xj, xp = jnp.asarray(X), torch.as_tensor(X)
    for _ in range(3):
        jm.zero_grad_parameters()
        pm.zero_grad_parameters()
        yj, yp = jm.forward(xj), pm.forward(xp)
        np.testing.assert_allclose(yp.detach().numpy(), yj, **TOL)
        gj = jm.backward(xj, jnp.asarray(GO))
        gp = pm.backward(xp, torch.as_tensor(GO))
        np.testing.assert_allclose(gp.numpy(), gj, **TOL)
        assert_trees_close(pm.grad_tree(), jm.grad_tree())
        jm.update_parameters(0.1)
        pm.update_parameters(0.1)
        assert_trees_close(pm.param_tree(), jm.param_tree())
    assert pm.output is yp and pm.grad_input is gp


def test_split_verbs_equal_backward_and_accumulate():
    _, pm = mlp_pair()
    x, go = torch.as_tensor(X), torch.as_tensor(GO)
    pm.zero_grad_parameters()
    pm.forward(x)
    gi = pm.backward(x, go)                       # the forward's graph
    once = {k: v.copy() for k, v in flat_tree(pm.grad_tree()).items()}
    gi2 = pm.update_grad_input(x, go)             # replays
    pm.acc_grad_parameters(x, go)
    np.testing.assert_allclose(gi2.numpy(), gi.numpy(), rtol=1e-6)
    for k, v in flat_tree(pm.grad_tree()).items():
        np.testing.assert_allclose(v, 2 * once[k], rtol=1e-6, err_msg=k)
    gi3 = pm.backward(x, go)                      # graph used: a replay
    np.testing.assert_allclose(gi3.numpy(), gi.numpy(), rtol=1e-6)


def test_backward_uses_the_forward_graph_once(monkeypatch):
    _, pm = mlp_pair()
    x, go = torch.as_tensor(X), torch.as_tensor(GO)
    calls = []
    real = pm.apply_fn
    monkeypatch.setattr(pm, "apply_fn",
                        lambda *a: calls.append(1) or real(*a))
    pm.forward(x)
    pm.backward(x, go)
    assert len(calls) == 1                 # one forward for the step
    pm.backward(x, go)
    assert len(calls) == 2                 # then a replay
    with torch.no_grad():
        pm.forward(x)
    pm.backward(x, go)
    assert len(calls) == 4


def test_torch_call_keeps_no_graph_and_makes_no_input_leaf():
    """``module(x)`` is PyTorch's call: the input stays as given (no
    leaf, so no input gradient is computed), the module keeps neither
    the output nor the graph, and a later ``backward`` replays the
    forward's dropout mask; after a verbs ``backward`` the record lets
    its tensors go."""
    import gc
    import weakref

    pm = tnn.Sequential(tnn.Linear(6, 5, **CPU), tnn.Dropout(0.5, **CPU),
                        tnn.Linear(5, 2, **CPU))
    x, go = torch.as_tensor(X), torch.as_tensor(GO)
    y = pm(x)
    assert y.requires_grad and not x.requires_grad
    assert pm.output is None and pm._fwd.output is None
    leaves, todo = set(), [y.grad_fn]
    while todo:                            # the graph's leaves
        fn = todo.pop()
        if hasattr(fn, "variable"):
            leaves.add(id(fn.variable))
        todo += [n for n, _ in fn.next_functions if n is not None]
    assert leaves == {id(p) for p in pm.parameters()}
    ref = weakref.ref(y)
    pm.zero_grad_parameters()
    y.backward(go)
    want = {n: p.grad.clone() for n, p in pm.named_parameters()}
    pm.zero_grad_parameters()
    pm.backward(x, go)
    for n, p in pm.named_parameters():
        torch.testing.assert_close(p.grad, want[n], rtol=0, atol=0)
    del y
    gc.collect()
    assert ref() is None                   # the caller's graph is gone

    out = pm.forward(x)
    leaf = pm._fwd.leaves
    pm.backward(x, go)
    assert pm._fwd.output is None and pm._fwd.leaves is None
    assert pm.output is out and leaf.requires_grad


def test_replay_leaves_running_statistics_alone():
    m = tnn.Sequential(tnn.Linear(6, 6, **CPU),
                       tnn.BatchNormalization(6, **CPU))
    x = torch.as_tensor(X)
    m.forward(x)
    stats = [b.clone() for b in m.buffers()]
    m.update_grad_input(x, torch.ones(4, 6))
    for b, s in zip(m.buffers(), stats):
        torch.testing.assert_close(b, s, rtol=0, atol=0)


def test_gradient_scale():
    """setScaleW/setScaleB (reference AbstractModule.scala:70-101), as
    ``tests/test_layers_oracle.py::test_gradient_scale``."""
    jl = jnn.Linear(3, 2)
    pl = tnn.Linear(3, 2, **CPU)
    load_param_tree(pl, jax.tree_util.tree_map(np.asarray, jl.param_tree()))
    x, go = np.ones((4, 3), np.float32), np.ones((4, 2), np.float32)
    grads = []
    for sw, sb in ((1.0, 1.0), (0.5, 2.0)):
        for m, conv in ((jl, jnp.asarray), (pl, torch.as_tensor)):
            m.set_scale_w(sw).set_scale_b(sb)
            m.zero_grad_parameters()
            m.forward(conv(x))
            m.backward(conv(x), conv(go))
        assert_trees_close(pl.grad_tree(), jl.grad_tree())
        grads.append({k: v.copy()
                      for k, v in flat_tree(pl.grad_tree()).items()})
    np.testing.assert_allclose(grads[1]["weight"], 0.5 * grads[0]["weight"])
    np.testing.assert_allclose(grads[1]["bias"], 2.0 * grads[0]["bias"])
    assert flat_tree(pl.gradient_scale_tree()) == {"weight": 0.5,
                                                   "bias": 2.0}


def test_flat_parameters_and_weights():
    jm, pm = mlp_pair()
    w, g = pm.get_parameters()
    assert w.shape == (pm.n_parameters(),) == (6 * 5 + 5 + 5 * 2 + 2,)
    assert pm.n_parameters() == jm.n_parameters()
    assert float(g.abs().sum()) == 0.0
    pm.set_flat_parameters(w * 2)
    np.testing.assert_allclose(pm.get_parameters()[0].numpy(),
                               2 * w.numpy())
    # weights in each layer's registration order: weight, then bias
    ws = pm.get_weights()
    assert [a.shape for a in ws] == [(5, 6), (5,), (2, 5), (2,)]
    pm.set_weights([a / 2 for a in ws])
    np.testing.assert_allclose(pm.get_parameters()[0].numpy(), w.numpy(),
                               rtol=1e-6)
    with pytest.raises(ValueError):
        pm.set_weights(ws[:1])
    weights, grads = pm.weights_and_grads()
    assert len(weights) == len(grads) == 4


def test_save_load_and_weights(tmp_path):
    jm, pm = mlp_pair()
    pm.set_name("mlp").set_scale_w(0.5)
    pm.save(str(tmp_path / "m.bigdl"))
    with pytest.raises(FileExistsError):
        pm.save(str(tmp_path / "m.bigdl"))
    back = load_module(str(tmp_path / "m.bigdl"), device="cpu")
    assert back.get_name() == "mlp" and back.scale_w == 0.5
    assert all(isinstance(p, torch.nn.Parameter) for p in back.parameters())
    x = torch.as_tensor(X)
    torch.testing.assert_close(back.forward(x), pm.forward(x))
    pm.save_weights(str(tmp_path / "w.bigdl"))
    other = mlp_pair()[1]
    other.load_weights(str(tmp_path / "w.bigdl"))
    assert_trees_close(other.param_tree(), jm.param_tree())


def test_clone_is_independent():
    _, pm = mlp_pair()
    c = pm.clone_module()
    with torch.no_grad():
        c[0].weight.add_(1.0)
    assert not torch.equal(c[0].weight, pm[0].weight)


@pytest.mark.parametrize("verb,args", [
    ("save_torch", ("x.t7",)), ("save_caffe", ("a", "b")),
    ("save_tf", ((1, 6), "x.pb")), ("inputs", ())])
def test_unported_verbs_raise(verb, args):
    """The Torch7, Caffe and TF writers wait for the interop slice and
    raise.  ``inputs`` raised until the graph API was ported
    (nn/graph.py): it now returns a graph node of the module, fed by the
    nodes given (none here)."""
    m = tnn.Linear(6, 2, **CPU)
    if verb == "inputs":
        node = m.inputs(*args)
        assert isinstance(node, tnn.ModuleNode)
        assert node.element is m and node.prev_nodes == []
        return
    with pytest.raises(NotImplementedError, match="not ported"):
        getattr(m, verb)(*args)


def test_init_methods_apply():
    """``tests/test_layer_zoo_sweep.py::test_init_methods_apply`` on the
    port's layers."""
    lin = tnn.Linear(16, 8, **CPU)
    g = torch.Generator().manual_seed(0)
    lin.set_init_method(tnn.Zeros(), tnn.Zeros(), g)
    assert float(lin.weight.abs().max()) == 0.0
    lin.set_init_method(tnn.Ones(), tnn.ConstInitMethod(0.5), g)
    assert float(lin.weight[0, 0]) == 1.0 and float(lin.bias[0]) == 0.5
    lin.set_init_method(tnn.Xavier(), tnn.Zeros(), g)
    w = lin.weight.detach().numpy()
    limit = np.sqrt(6.0 / (16 + 8))
    assert np.all(np.abs(w) <= limit + 1e-6) and w.std() > 0
    lin.set_init_method(tnn.RandomNormal(0.0, 0.01), tnn.Zeros(), g)
    assert abs(float(lin.weight.std()) - 0.01) < 0.005
    conv = tnn.SpatialConvolution(2, 4, 3, 3, **CPU)
    conv.set_init_method(tnn.MsraFiller(), tnn.Zeros(), g)
    assert float(conv.weight.std()) > 0
    from bigdl_tpu.nn import BilinearFiller

    np.testing.assert_array_equal(
        tnn.BilinearFiller().init((2, 2, 4, 4)).numpy(),
        np.asarray(BilinearFiller().init((2, 2, 4, 4))))
    # reset re-draws from the layer's default init
    before = lin.weight.detach().clone()
    lin._init_methods.clear()
    lin.reset(torch.Generator().manual_seed(1))
    assert not torch.equal(before, lin.weight)
    assert float(lin.weight.abs().max()) <= 1 / 4 + 1e-6


def test_times_traversal_and_names():
    _, pm = mlp_pair()
    pm[1].set_name("act")
    assert pm.find_module("act") is pm[1]
    assert [m.get_name() for m in pm.modules_iter()] == [
        "Sequential", "Linear", "act", "Linear"]
    x = torch.as_tensor(X)
    pm.forward(x)
    pm.backward(x, torch.as_tensor(GO))
    times = pm.get_times()
    assert times[0][1] > 0 and times[0][2] > 0
    pm.reset_times()
    assert all(f == b == 0.0 for _, f, b in pm.get_times())
    assert pm.get(1) is pm[0]


def test_conv_impl_reads_the_engine_property(monkeypatch):
    """A SpatialConvolution with no impl set reads ``bigdl.conv.impl``
    at each call, "xla" when unset (bigdl_tpu/nn/conv.py:89-90)."""
    seen = []
    conv = tnn.SpatialConvolution(2, 3, 3, 3, **CPU)
    monkeypatch.setattr(conv, "_native", lambda x, w: seen.append("xla")
                        or torch.zeros(1, 3, 2, 2))
    import bigdl_tpu_torch.nn.conv as conv_mod

    monkeypatch.setattr(conv_mod, "conv2d_gemm_nchw",
                        lambda *a: seen.append("gemm")
                        or torch.zeros(1, 3, 2, 2))
    x = torch.zeros(1, 2, 4, 4)
    conv.forward(x)
    monkeypatch.setenv("BIGDL_CONV_IMPL", "gemm")
    conv.forward(x)
    conv.set_conv_impl("xla").forward(x)
    assert seen == ["xla", "gemm", "xla"]


# --------------------------------------------------------------------------
# Engine, util
# --------------------------------------------------------------------------

def test_engine_single_device(monkeypatch):
    from bigdl_tpu_torch.utils.engine import Engine, get_property

    Engine.reset()
    assert not Engine.check_singleton()
    assert Engine.node_number() == 1
    # one process drives one device: its core number is 1
    assert Engine.core_number() == 1
    assert Engine.check_singleton()
    Engine.init(node_number=2, core_number=4)
    assert Engine.device_count() == 8
    monkeypatch.setenv("BIGDL_CORE_NUMBER", "3")
    Engine.init()
    assert Engine.core_number() == 3
    monkeypatch.setenv("BIGDL_FOO_BAR", "x")
    assert get_property("bigdl.foo.bar") == "x"
    assert get_property("bigdl.absent", "d") == "d"
    # the mesh factory: a group of one on the CPU when asked for, a
    # ("data",) mesh over it, the model axes refused; reset ends the group
    import torch.distributed as dist

    Engine.reset()
    try:
        mesh = Engine.default_mesh(device="cpu")
        assert mesh.mesh_dim_names == ("data",) and mesh.size() == 1
        assert Engine.node_number() == 1 and dist.get_backend() == "gloo"
        with pytest.raises(NotImplementedError, match="not ported"):
            Engine.create_mesh(model=2)
    finally:
        Engine.reset()
    assert not dist.is_initialized()


def test_util_matches_jax(tmp_path):
    from bigdl_tpu.utils.util import kth_largest as jk
    from bigdl_tpu_torch.utils.util import LoggerFilter, kth_largest

    vals = list(R.rand(9))
    for k in (1, 4, 9):
        assert kth_largest(vals, k) == jk(vals, k)
    path = LoggerFilter.redirect_engine_logs(str(tmp_path / "bigdl.log"))
    logging.getLogger("bigdl_tpu").info("hello")
    for h in logging.getLogger("bigdl_tpu").handlers:
        h.flush()
    assert "hello" in open(path).read()


# --------------------------------------------------------------------------
# DirectedGraph (tests/test_directed_graph.py on the port's copy)
# --------------------------------------------------------------------------

def _diamond():
    from bigdl_tpu_torch.utils.directed_graph import Node

    a, b, c, d = Node("a"), Node("b"), Node("c"), Node("d")
    a.add(b)
    a.add(c)
    b.add(d)
    c.add(d)
    return a, b, c, d


def test_size_and_edges():
    a, *_ = _diamond()
    assert a.graph().size() == 4
    assert a.graph().edges() == 4


def test_topology_sort_respects_dependencies():
    a, b, c, d = _diamond()
    order = [n.element for n in a.graph().topology_sort()]
    assert order.index("a") < order.index("b") < order.index("d")
    assert order.index("a") < order.index("c") < order.index("d")


def test_reverse_graph_walks_prev_edges():
    from bigdl_tpu_torch.utils.directed_graph import DirectedGraph

    a, b, c, d = _diamond()
    order = [n.element for n in DirectedGraph(d, reverse=True).topology_sort()]
    assert order.index("d") < order.index("b") < order.index("a")


def test_cycle_detection():
    from bigdl_tpu_torch.utils.directed_graph import Node

    a, b = Node("a"), Node("b")
    a.add(b)
    b.add(a)
    with pytest.raises(ValueError, match="cycle"):
        a.graph().topology_sort()


def test_bfs_dfs_visit_all_once():
    a, *_ = _diamond()
    bfs = [n.element for n in a.graph().bfs()]
    dfs = [n.element for n in a.graph().dfs()]
    assert sorted(bfs) == sorted(dfs) == ["a", "b", "c", "d"]
    assert bfs[0] == dfs[0] == "a"


def test_delete_edge():
    a, b, c, d = _diamond()
    b.delete(d)
    assert a.graph().edges() == 3
    assert d not in b.next_nodes and b not in d.prev_nodes


# --------------------------------------------------------------------------
# predict (the single-device half of tests/test_predictor.py)
# --------------------------------------------------------------------------

def _classifier_and_data(n=37):
    from bigdl_tpu.dataset import Sample as JSample
    from bigdl_tpu.dataset import array as jarray
    from bigdl_tpu_torch.dataset import Sample, array

    rng = np.random.RandomState(0)
    jm = jnn.Sequential(jnn.Linear(4, 8), jnn.Tanh(), jnn.Linear(8, 3),
                        jnn.LogSoftMax())
    pm = tnn.Sequential(tnn.Linear(4, 8, **CPU), tnn.Tanh(**CPU),
                        tnn.Linear(8, 3, **CPU), tnn.LogSoftMax(**CPU))
    load_param_tree(pm, jax.tree_util.tree_map(np.asarray, jm.param_tree()))
    feats = [rng.rand(4).astype(np.float32) for _ in range(n)]
    labels = [np.float32(1 + i % 3) for i in range(n)]
    return (jm, jarray([JSample(f, y) for f, y in zip(feats, labels)]),
            pm, array([Sample(f, y) for f, y in zip(feats, labels)]))


def test_predict_matches_jax():
    jm, jdata, pm, pdata = _classifier_and_data()
    want = jm.predict(jdata, batch_size=32)
    got = pm.predict(pdata, batch_size=32)
    assert len(got) == len(want) == 37
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    assert pm.predict_class(pdata, batch_size=8) == \
        jm.predict_class(jdata, batch_size=8)
    from bigdl_tpu_torch.optim.predictor import Predictor

    # a mesh is a torch.distributed DeviceMesh (tests/test_torch_distri.py
    # predicts over one)
    with pytest.raises(TypeError, match="DeviceMesh"):
        Predictor(pm, mesh=object())


# --------------------------------------------------------------------------
# the gradient checker
# --------------------------------------------------------------------------

@pytest.mark.parametrize("make,x", [
    (lambda: tnn.Linear(5, 3, **CPU), R.randn(2, 5)),
    (lambda: tnn.Sequential(tnn.Linear(4, 4, **CPU), tnn.Tanh(**CPU),
                            tnn.CMul([4], **CPU)), R.randn(3, 4)),
    (lambda: tnn.SpatialCrossMapLRN(3, **CPU), R.randn(1, 4, 3, 3)),
    (lambda: tnn.Cosine(4, 2, **CPU), R.randn(2, 4)),
    (lambda: tnn.Euclidean(4, 2, **CPU), R.randn(2, 4)),
    (lambda: tnn.SoftMax(**CPU), R.randn(2, 5))])
def test_gradient_checker_passes_on_port_layers(make, x):
    from bigdl_tpu_torch.utils.gradient_checker import GradientChecker

    checker = GradientChecker(1e-4, 1e-4)
    m = make()
    assert checker.check_layer(m, x)
    if list(m.parameters()):
        assert checker.check_weight(m, x)


class _WrongSquare(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * x

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return 3 * x * g                 # planted: d(x^2)/dx is 2x


class _WrongScale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x)
        return x * w

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g, -(g * x).sum(0)        # planted sign error in dW


def test_gradient_checker_catches_a_planted_wrong_backward():
    from bigdl_tpu_torch.utils.gradient_checker import GradientChecker

    class BadSquare(tnn.TensorModule):
        def _compute(self, params, x):
            return _WrongSquare.apply(x)

    class BadScale(tnn.TensorModule):
        def __init__(self):
            super().__init__("cpu")
            self._register_param("weight", torch.ones(4))

        def _compute(self, params, x):
            return _WrongScale.apply(x, params["weight"])

    checker = GradientChecker(1e-4, 1e-4)
    x = R.randn(3, 4)
    assert not checker.check_layer(BadSquare("cpu"), x)
    assert checker.check_layer(BadScale(), x)
    assert not checker.check_weight(BadScale(), x)
    assert checker.check_layer(tnn.Square(**CPU), x)


# --------------------------------------------------------------------------
# coverage: every public verb of the JAX package's classes has a port
# counterpart, or is named here with its reason
# --------------------------------------------------------------------------

#: JAX name -> where it lives in the port, and why it differs
RENAMED_VERBS = {
    "parameters": "weights_and_grads(): parameters() stays PyTorch's "
                  "iterator, which every torch utility walks",
    "training": "train(): training is the mode flag of every "
                "torch.nn.Module",
    "params": "the registered torch Parameters (param_tree())",
    "grads": "each Parameter's .grad (grad_tree())",
    "buffers": "the registered torch buffers (buffer_tree())",
    "is_training": "the torch.nn.Module flag training",
}
#: JAX verbs that raise the port's _not_ported, and why
UNPORTED_VERBS = {
    "save_torch": "the Torch7 writer comes with the interop slice",
    "save_caffe": "the Caffe writer comes with the interop slice",
    "save_tf": "the TF writer comes with the interop slice",
}


def _public(cls):
    return {n for n in dir(cls) if not n.startswith("_")}


def test_every_module_verb_is_ported_or_named():
    from bigdl_tpu.nn.module import AbstractModule as JModule
    from bigdl_tpu.nn.module import Container as JContainer

    names = (_public(JModule) | _public(JContainer)
             | set(vars(JModule())) - {"name"})
    names = {n for n in names if not n.startswith("_")}
    port = tnn.Container(tnn.Linear(2, 2, **CPU))
    missing = sorted(n for n in names - set(RENAMED_VERBS)
                     if not hasattr(port, n))
    assert not missing, f"unported verbs without a reason: {missing}"
    for verb in UNPORTED_VERBS:
        assert hasattr(port, verb)


def test_tensor_checker_graph_and_engine_surfaces_are_ported():
    from bigdl_tpu import tensor as jt
    from bigdl_tpu.utils import directed_graph as jdg
    from bigdl_tpu.utils import engine as je
    from bigdl_tpu.utils.gradient_checker import GradientChecker as JGC
    from bigdl_tpu_torch import tensor as pt
    from bigdl_tpu_torch.utils import directed_graph as pdg
    from bigdl_tpu_torch.utils import engine as pe
    from bigdl_tpu_torch.utils.gradient_checker import GradientChecker

    for jcls, pcls in ((jt.Tensor, pt.Tensor), (JGC, GradientChecker),
                       (jdg.Node, pdg.Node),
                       (jdg.DirectedGraph, pdg.DirectedGraph)):
        assert not _public(jcls) - _public(pcls), jcls
    jt_fns = {"tensor", "zeros", "ones", "rand", "randn", "arange", "range_"}
    assert all(hasattr(pt, f) and hasattr(jt, f) for f in jt_fns)
    # the JAX-only helper re-applies JAX_PLATFORMS; the rest is ported
    assert _public(je.Engine) - _public(pe.Engine) == {
        "honor_jax_platforms_env"}
