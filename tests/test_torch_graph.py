"""The port's graph API (bigdl_tpu_torch.nn.graph, ``module(node)`` and
``inputs``) against the JAX package's, in f32 on the CPU.

The graphs mirror ``tests/test_containers_graph.py``'s graph specs: a
diamond, a multi-input multi-output graph, a graph equal to a
Sequential, and ``lenet_graph`` = ``LeNet5``.  Each JAX graph's weights
load into the port's by key (``load_param_tree``: the keys are the
sorted nodes' ``str(i)`` in ``topo_sort``'s DFS post-order), and the
two graphs' forward, input gradient and parameter gradients agree at
the layer zoo's tolerance.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as jnn
from bigdl_tpu.models.lenet import LeNet5 as JLeNet5
from bigdl_tpu.models.lenet import lenet_graph as jlenet_graph
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.interop import load_param_tree
from bigdl_tpu_torch.models.lenet import LeNet5, lenet_graph
from bigdl_tpu_torch.utils.table import Table as PTable
from test_torch_layer_zoo import T, flat_tree, run_pair

torch.set_num_threads(1)

CPU = dict(device="cpu")
X = np.random.RandomState(5).randn(3, 4).astype(np.float32)


def _diamond(nn, **kw):
    inp = nn.Input(**kw)
    l1 = nn.Linear(4, 4, **kw)(inp)
    b1 = nn.ReLU(**kw)(l1)
    b2 = nn.Tanh(**kw)(l1)
    add = nn.CAddTable(**kw)([b1, b2])
    out = nn.Linear(4, 2, **kw)(add)
    return nn.Graph(inp, out, **kw)


def _multi(nn, **kw):
    in1, in2 = nn.Input(**kw), nn.Input(**kw)
    j = nn.JoinTable(2, **kw)([in1, in2])
    h = nn.Linear(8, 4, **kw)(j)
    o1 = nn.ReLU(**kw)(h)
    o2 = nn.Tanh(**kw)(h)
    return nn.Graph([in1, in2], [o1, o2], **kw)


def _ordered(nn, **kw):
    """A node fed by two predecessors in the opposite order of their
    creation: CSubTable gets Table(b, a) in ``prev_nodes`` order."""
    inp = nn.Input(**kw)
    a = nn.Linear(4, 3, **kw)(inp)
    b = nn.Tanh(**kw)(nn.Linear(4, 3, **kw)(inp))
    out = nn.CSubTable(**kw)(b, a)
    return nn.Graph(inp, out, **kw)


@pytest.mark.parametrize("builder,inp", [
    (_diamond, X),
    (_multi, T(X, 2 * X)),
    (_ordered, X),
], ids=["diamond", "multi_input_output", "prev_nodes_order"])
def test_graph_matches_jax_on_carried_weights(builder, inp):
    jg = builder(jnn)
    pg = builder(tnn, **CPU)
    # the same keys as the JAX graph's: one per sorted node
    assert sorted(pg.param_tree()) == sorted(jg.param_tree())
    got, want = run_pair(jg, pg, inp)
    if builder is _multi:
        assert isinstance(got, PTable) and got.length() == 2
        assert tuple(got[1].shape) == (3, 4) and tuple(got[2].shape) == (3, 4)


def test_graph_equals_sequential():
    lin1 = tnn.Linear(4, 8, **CPU)
    relu = tnn.ReLU(**CPU)
    lin2 = tnn.Linear(8, 2, **CPU)
    x = torch.from_numpy(X)
    seq = tnn.Sequential(lin1, relu, lin2)
    want = seq(x)
    inp = tnn.Input(**CPU)
    g = tnn.Graph(inp, lin2(relu(lin1(inp))))
    torch.testing.assert_close(g(x), want, rtol=0, atol=0)


def test_lenet_graph_is_lenet5_bit_for_bit():
    seq = LeNet5(device="cpu", generator=torch.Generator().manual_seed(3))
    g = lenet_graph(device="cpu")
    # the graph's node 0 is the input; its layers follow in LeNet5's order
    leaves = list(g.parameters())
    with torch.no_grad():
        for p, q in zip(leaves, seq.parameters(), strict=True):
            p.copy_(q)
    x = torch.from_numpy(
        np.random.RandomState(0).rand(4, 28, 28).astype(np.float32))
    y_seq, y_g = seq.forward(x), g.forward(x)
    assert torch.equal(y_seq, y_g)
    go = torch.from_numpy(np.random.RandomState(1).randn(4, 10).astype(
        np.float32))
    seq.zero_grad_parameters()
    g.zero_grad_parameters()
    assert torch.equal(seq.backward(x, go), g.backward(x, go))
    for p, q in zip(leaves, seq.parameters(), strict=True):
        assert torch.equal(p.grad, q.grad)


def test_lenet_graph_matches_jax_lenet_graph():
    jg = jlenet_graph()
    pg = lenet_graph(device="cpu")
    x = np.random.RandomState(2).rand(2, 28, 28).astype(np.float32)
    run_pair(jg, pg, x)


def test_jax_graph_weights_load_by_key():
    """A JAX graph's tree, keyed by its own sorted nodes, loads into the
    port's graph and nowhere else: a missing key names its path."""
    jg = _diamond(jnn)
    pg = _diamond(tnn, **CPU)
    tree = jax.tree_util.tree_map(np.asarray, jg.param_tree())
    load_param_tree(pg, tree)
    got = flat_tree(pg.param_tree())
    want = flat_tree(tree)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # the sequential LeNet's tree is not the graph's
    with pytest.raises(KeyError):
        load_param_tree(lenet_graph(device="cpu"),
                        jax.tree_util.tree_map(np.asarray,
                                               JLeNet5().param_tree()))


def test_call_on_nodes_wires_and_tensors_keep_the_forward():
    lin = tnn.Linear(4, 2, **CPU)
    a, b = tnn.Input(**CPU), tnn.Input(**CPU)
    node = lin(a)
    assert isinstance(node, tnn.ModuleNode) and node.element is lin
    assert node.prev_nodes == [a] and a.next_nodes == [node]
    join = tnn.JoinTable(2, **CPU)
    n2 = join([a, b])
    n3 = tnn.JoinTable(2, **CPU)(a, b)
    assert n2.prev_nodes == [a, b] and n3.prev_nodes == [a, b]
    n4 = lin.inputs(b)
    assert isinstance(n4, tnn.ModuleNode) and n4.prev_nodes == [b]
    # a tensor or a Table still runs the forward
    x = torch.from_numpy(X)
    torch.testing.assert_close(lin(x), x @ lin.weight.t() + lin.bias)
    out = tnn.JoinTable(2, **CPU)(PTable(x, x))
    assert tuple(out.shape) == (3, 8)


def test_model_factory_and_disconnected_input():
    inp = tnn.Input(**CPU)
    out = tnn.ReLU(**CPU)(inp)
    g = tnn.Model(inp, out)
    assert isinstance(g, tnn.Graph)
    stray = tnn.Input(**CPU)
    with pytest.raises(ValueError):
        tnn.Graph([inp, stray], out)


def test_graph_trains_like_jax_through_the_verbs():
    """Three SGD steps through the verbs (forward, criterion, backward,
    update_parameters) on the diamond: the port's losses and parameters
    track the JAX graph's at rtol 2e-3."""
    jg = _diamond(jnn)
    pg = _diamond(tnn, **CPU)
    load_param_tree(pg, jax.tree_util.tree_map(np.asarray, jg.param_tree()))
    rng = np.random.RandomState(4)
    x = rng.randn(6, 4).astype(np.float32)
    y = rng.randn(6, 2).astype(np.float32)
    jc, pc = jnn.MSECriterion(), tnn.MSECriterion()
    losses = {"jax": [], "port": []}
    for _ in range(3):
        for tag, g, c, xx, yy in (
                ("jax", jg, jc, jnp.asarray(x), jnp.asarray(y)),
                ("port", pg, pc, torch.from_numpy(x), torch.from_numpy(y))):
            g.zero_grad_parameters()
            out = g.forward(xx)
            losses[tag].append(float(c.forward(out, yy)))
            g.backward(xx, c.backward(out, yy))
            g.update_parameters(0.1)
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=2e-3)
    assert losses["port"][-1] < losses["port"][0]
    got = flat_tree(pg.param_tree())
    want = flat_tree(jax.tree_util.tree_map(np.asarray, jg.param_tree()))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-3, atol=1e-5,
                                   err_msg=k)
