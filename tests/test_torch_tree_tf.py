"""The port's Tree-LSTM (bigdl_tpu_torch.nn.tree) and TF ops
(bigdl_tpu_torch.nn.tf_ops) against the JAX package's, in f32 on the
CPU.

They mirror the tree and TF halves of ``tests/test_text_tree_tf.py``:
``BinaryTreeLSTM`` against a recursive numpy oracle (both gate modes),
its gradients, the ``TensorTree`` helpers, ``Const``/``Fill``/``Shape``,
``SplitAndSelect``, ``StrideSlice`` and ``Nms`` against the naive greedy
loop; and each beside the JAX layer on carried weights (``run_pair``:
forward, input and parameter gradients at the layer zoo's tolerance).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bigdl_tpu import nn as jnn
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.utils.table import Table
from test_torch_layer_zoo import T, run_pair
from test_text_tree_tf import _tree_oracle

torch.set_num_threads(1)

CPU = dict(device="cpu")

# root 1 = (2, 3); 3 = (4, 5); leaves 2, 4, 5 -> tokens 1, 2, 3; the last
# row is padding
TREE = np.array([[2, 3, -1],
                 [0, 0, 1],
                 [4, 5, 0],
                 [0, 0, 2],
                 [0, 0, 3],
                 [-1, -1, 0]], np.float32)
# a second shape: root 1 = (4, 2), 2 = (3, 5), leaves in another order
TREE2 = np.array([[4, 2, -1],
                  [3, 5, 0],
                  [0, 0, 3],
                  [0, 0, 1],
                  [0, 0, 2],
                  [-1, -1, 0]], np.float32)


def _inputs():
    x = np.random.RandomState(0).randn(2, 3, 4).astype(np.float32)
    return x, np.stack([TREE, TREE2])


@pytest.mark.parametrize("gate_output", [True, False])
def test_binary_tree_lstm_matches_recursive_oracle(gate_output):
    m = tnn.BinaryTreeLSTM(4, 3, gate_output=gate_output, **CPU)
    x, trees = _inputs()
    out = m.forward(Table(torch.from_numpy(x), torch.from_numpy(trees)))
    params = {k: v.detach().numpy() for k, v in m.param_tree().items()}
    for b in range(2):
        want = _tree_oracle(params, x[b], trees[b], 3, gate_output)
        np.testing.assert_allclose(out[b].detach().numpy(), want, rtol=1e-4,
                                   atol=1e-5)
    assert not out[:, -1].any()       # the padding row


def test_binary_tree_lstm_gradients_reach_every_weight():
    m = tnn.BinaryTreeLSTM(4, 3, **CPU)
    x, trees = _inputs()
    inp = Table(torch.from_numpy(x), torch.from_numpy(trees))
    out = m.forward(inp)
    m.zero_grad_parameters()
    m.backward(inp, 2 * out.detach())
    grads = m.grad_tree()
    assert float(grads["comp_l_w"].abs().sum()) > 0
    assert float(grads["leaf_c_w"].abs().sum()) > 0


@pytest.mark.parametrize("cls", ["BinaryTreeLSTM", "TreeLSTM"])
@pytest.mark.parametrize("gate_output", [True, False])
def test_tree_lstm_matches_jax(cls, gate_output):
    x, trees = _inputs()
    run_pair(getattr(jnn, cls)(4, 3, gate_output=gate_output),
             getattr(tnn, cls)(4, 3, gate_output=gate_output, **CPU),
             T(x, trees))


def test_tensor_tree_helpers():
    t = tnn.TensorTree(np.zeros((3, 3), np.float32))
    t.add_child(1, 2)
    t.add_child(1, 3)
    t.mark_as_root(1)
    t.mark_as_leaf(2, 1)
    t.mark_as_leaf(3, 2)
    assert t.get_root() == 1
    assert t.has_child(1) and t.no_child(2)
    assert t.leaf_index(3) == 2
    assert t.children(1).tolist()[:2] == [2, 3]
    assert t.exists(3) and not t.exists(4) and not t.is_padding(2)
    j = jnn.TensorTree(np.zeros((3, 3), np.float32))
    for op in (lambda u: u.add_child(1, 2), lambda u: u.add_child(1, 3),
               lambda u: u.mark_as_root(1), lambda u: u.mark_as_leaf(2, 1),
               lambda u: u.mark_as_leaf(3, 2)):
        op(j)
    np.testing.assert_array_equal(t.content, j.content)


# ---------------------------------------------------------------- TF ops

def test_const_fill_shape():
    c = tnn.Const(np.arange(3.0), **CPU)
    np.testing.assert_array_equal(c.forward(np.zeros(5)).numpy(), [0, 1, 2])
    f = tnn.Fill(7.0, **CPU)
    out = f.forward(np.array([2.0, 3.0]))
    assert tuple(out.shape) == (2, 3) and float(out[0, 0]) == 7.0
    assert out.dtype == torch.float32
    assert tnn.Fill(3, **CPU).forward(np.array([2.0])).dtype == torch.int32
    s = tnn.Shape(**CPU)
    out = s.forward(np.zeros((4, 5)))
    np.testing.assert_array_equal(out.numpy(), [4, 5])
    assert out.dtype == torch.int32


@pytest.mark.parametrize("name,args,x", [
    ("Const", (np.arange(6.0).reshape(2, 3),), np.zeros(5, np.float32)),
    ("Fill", (2.5,), np.array([2.0, 3.0], np.float32)),
    ("Shape", (), np.zeros((4, 5, 2), np.float32)),
])
def test_tf_constants_match_jax(name, args, x):
    want = np.asarray(getattr(jnn, name)(*args).forward(jnp.asarray(x)))
    got = getattr(tnn, name)(*args, **CPU).forward(x)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


def test_split_and_select():
    x = np.arange(12.0, dtype=np.float32).reshape(2, 6)
    m = tnn.SplitAndSelect(2, 2, 3, **CPU)
    np.testing.assert_array_equal(m.forward(x).numpy(), x[:, 2:4])


def test_stride_slice():
    x = np.arange(24.0, dtype=np.float32).reshape(2, 3, 4)
    m = tnn.StrideSlice([(1, 1, 2, 1), (3, 2, 4, 1)], **CPU)
    np.testing.assert_array_equal(m.forward(x).numpy(), x[0:1, :, 1:3])


@pytest.mark.parametrize("name,args", [
    ("SplitAndSelect", (2, 2, 3)),
    ("SplitAndSelect", (-1, 1, 2)),
    ("StrideSlice", ([(1, 1, 2, 1), (3, 2, 4, 1)],)),
    ("StrideSlice", ([(-1, 2, 5, 1), (2, 2, 6, 1)],)),
], ids=["split_dim2", "split_last", "slice", "slice_negative_dim"])
def test_slices_match_jax_forward_and_backward(name, args):
    x = np.random.RandomState(3).randn(3, 6, 6).astype(np.float32)
    run_pair(getattr(jnn, name)(*args), getattr(tnn, name)(*args, **CPU), x)


def _naive_nms(scores, boxes, thresh):
    areas = ((boxes[:, 2] - boxes[:, 0] + 1)
             * (boxes[:, 3] - boxes[:, 1] + 1))
    order = np.argsort(-scores, kind="stable").tolist()
    keep = []
    while order:
        i = order.pop(0)
        keep.append(i)
        rest = []
        for j in order:
            w = min(boxes[i, 2], boxes[j, 2]) - max(boxes[i, 0], boxes[j, 0]) + 1
            h = min(boxes[i, 3], boxes[j, 3]) - max(boxes[i, 1], boxes[j, 1]) + 1
            inter = max(w, 0) * max(h, 0) if (w >= 0 and h >= 0) else 0
            if inter / (areas[i] + areas[j] - inter) <= thresh:
                rest.append(j)
        order = rest
    return keep


@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7])
def test_nms_matches_naive_and_jax(thresh):
    rng = np.random.RandomState(3)
    n = 40
    x1y1 = rng.rand(n, 2) * 50
    wh = rng.rand(n, 2) * 30 + 1
    boxes = np.concatenate([x1y1, x1y1 + wh], axis=1).astype(np.float32)
    scores = rng.rand(n).astype(np.float32)
    idx = np.zeros(n, np.int64)
    count = tnn.Nms().nms(torch.from_numpy(scores), torch.from_numpy(boxes),
                          thresh, idx)
    assert (idx[:count] - 1).tolist() == _naive_nms(scores, boxes, thresh)
    jidx = np.zeros(n, np.int64)
    jcount = jnn.Nms().nms(scores, boxes, thresh, jidx)
    assert count == jcount and np.array_equal(idx, jidx)
    assert tnn.Nms().nms(np.zeros(0), np.zeros((0, 4)), thresh, idx) == 0
