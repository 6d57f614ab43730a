"""Tree-structured LSTM (counterpart of ``bigdl_tpu/nn/tree.py``;
reference nn/TreeLSTM.scala:26, nn/BinaryTreeLSTM.scala:37 — the
constituency Tree-LSTM).

Tree encoding (reference TensorTree, BinaryTreeLSTM.scala:454-512): a
(node_number, width) tensor per sample; columns 0..width-2 hold 1-based
child node indices (0 = no child, -1 in column 0 = a padding row) and
the last column holds -1 for the root or the 1-based leaf index into the
token sequence for a leaf.

The JAX package evaluates a batch of trees as a masked fixed-point
iteration (``fori_loop``, ``node_number`` steps): each step computes the
composer for every node as one batched product and commits only the
nodes whose children are both ready.  The port runs the same N steps as
a Python loop, ``torch.gather`` in place of ``take_along_axis``, with the
same clipping of the child indices; padding rows stay zero.  Plain
PyTorch, as the JAX layer is plain ``jnp``.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike
from .initialization import ONE_D, RandomUniform
from .module import AbstractModule


class TensorTree:
    """Host-side helper for building and reading the tree tensor
    (reference BinaryTreeLSTM.scala:454-512); a copy of the JAX
    package's."""

    def __init__(self, content: np.ndarray):
        content = np.asarray(content, np.float32)
        assert content.ndim == 2, "TensorTree content must be 2-D"
        self.content = content

    @property
    def node_number(self) -> int:
        return self.content.shape[0]

    def children(self, index: int):
        return self.content[index - 1].astype(np.int64)

    def add_child(self, parent: int, child: int):
        row = self.content[parent - 1]
        for i in range(self.content.shape[1] - 1):
            if row[i] == 0:
                row[i] = child
                return

    def mark_as_root(self, index: int):
        self.content[index - 1, -1] = -1

    def get_root(self) -> int:
        for i in range(self.node_number):
            if int(self.content[i, -1]) == -1:
                return i + 1
        raise RuntimeError("There is no root in the tensor tree")

    def mark_as_leaf(self, index: int, leaf_index: int):
        self.content[index - 1, -1] = leaf_index

    def leaf_index(self, index: int) -> int:
        return int(self.content[index - 1, -1])

    def has_child(self, index: int) -> bool:
        return int(self.content[index - 1, 0]) > 0

    def no_child(self, index: int) -> bool:
        return int(self.content[index - 1, 0]) == 0

    def exists(self, index: int) -> bool:
        return 1 <= index <= self.node_number

    def is_padding(self, index: int) -> bool:
        return int(self.content[index - 1, 0]) == -1


def _gather_rows(states, idx):
    """states (B, N, ...) at node indices idx (B, N): take_along_axis on
    dim 1."""
    shape = idx.shape + states.shape[2:]
    index = idx.reshape(idx.shape + (1,) * (states.dim() - 2)).expand(shape)
    return torch.gather(states, 1, index)


class BinaryTreeLSTM(AbstractModule):
    """Binary (constituency) Tree-LSTM (reference
    BinaryTreeLSTM.scala:37).

    Input: ``Table(embeddings (B, L, input_size), trees (B, N, W))``.
    Output: (B, N, hidden_size), every node's hidden state (padding rows
    zero), the reference's ``updateOutput`` layout.

    Leaf:  c = W_c x + b_c;  h = sigmoid(W_o x + b_o) · tanh(c)
    [gate_output], else tanh(c).
    Composer, each gate g = act(W_l lh + b_l + W_r rh + b_r), gates
    i, lf, rf, u [, o]: c = i·u + lf·lc + rf·rc;  h = o · tanh(c)."""

    def __init__(self, input_size: int, hidden_size: int,
                 gate_output: bool = True, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device)
        self.input_size, self.hidden_size = input_size, hidden_size
        self.gate_output = gate_output
        H, I = hidden_size, input_size
        n_gates = 5 if gate_output else 4

        def uni(name, shape, stdv):
            init = RandomUniform(-stdv, stdv)
            self._register_param(name, init.init(shape, ONE_D, generator),
                                 init, ONE_D)

        uni("leaf_c_w", (H, I), 1.0 / math.sqrt(I))
        uni("leaf_c_b", (H,), 1.0 / math.sqrt(I))
        if gate_output:
            uni("leaf_o_w", (H, I), 1.0 / math.sqrt(I))
            uni("leaf_o_b", (H,), 1.0 / math.sqrt(I))
        stdv = 1.0 / math.sqrt(H)
        uni("comp_l_w", (n_gates * H, H), stdv)
        uni("comp_l_b", (n_gates * H,), stdv)
        uni("comp_r_w", (n_gates * H, H), stdv)
        uni("comp_r_b", (n_gates * H,), stdv)

    def _compute(self, params, inp):
        x, trees = inp[1], inp[2]
        dt = params["leaf_c_w"].dtype
        x = x.to(dt)
        N = trees.shape[1]
        H = self.hidden_size
        left = trees[:, :, 0].to(torch.int64)    # 1-based; 0 none, -1 pad
        right = trees[:, :, 1].to(torch.int64)
        marker = trees[:, :, -1].to(torch.int64)  # -1 root / leaf index
        is_leaf = left == 0
        is_pad = left == -1
        is_comp = left > 0

        # every leaf at once: one (B, N, I) gather, one product
        leaf_in = _gather_rows(x, (marker - 1).clamp(0, x.shape[1] - 1))
        leaf_c = leaf_in @ params["leaf_c_w"].t() + params["leaf_c_b"]
        if self.gate_output:
            o = torch.sigmoid(leaf_in @ params["leaf_o_w"].t()
                              + params["leaf_o_b"])
            leaf_h = o * torch.tanh(leaf_c)
        else:
            leaf_h = torch.tanh(leaf_c)
        zero = leaf_c.new_zeros(())
        c = torch.where(is_leaf[..., None], leaf_c, zero)
        h = torch.where(is_leaf[..., None], leaf_h, zero)
        ready = is_leaf | is_pad
        li = (left - 1).clamp(0, N - 1)
        ri = (right - 1).clamp(0, N - 1)
        for _ in range(N):
            lc, lh = _gather_rows(c, li), _gather_rows(h, li)
            rc, rh = _gather_rows(c, ri), _gather_rows(h, ri)
            pre = (lh @ params["comp_l_w"].t() + params["comp_l_b"]
                   + rh @ params["comp_r_w"].t() + params["comp_r_b"])
            i_g = torch.sigmoid(pre[..., 0:H])
            lf = torch.sigmoid(pre[..., H:2 * H])
            rf = torch.sigmoid(pre[..., 2 * H:3 * H])
            u = torch.tanh(pre[..., 3 * H:4 * H])
            cc = i_g * u + lf * lc + rf * rc
            if self.gate_output:
                hh = torch.sigmoid(pre[..., 4 * H:5 * H]) * torch.tanh(cc)
            else:
                hh = torch.tanh(cc)
            commit = (is_comp & torch.gather(ready, 1, li)
                      & torch.gather(ready, 1, ri) & ~ready)
            c = torch.where(commit[..., None], cc, c)
            h = torch.where(commit[..., None], hh, h)
            ready = ready | commit
        return torch.where(is_pad[..., None], zero, h)


class TreeLSTM(BinaryTreeLSTM):
    """The base name kept for API parity (reference TreeLSTM.scala:26 is
    the abstract parent of BinaryTreeLSTM)."""
