"""The recurrent stack (counterpart of ``bigdl_tpu/nn/recurrent.py``;
reference nn/Cell.scala:43, Recurrent.scala:32, RnnCell, LSTM.scala:50,
LSTMPeephole, GRU.scala:54, ConvLSTMPeephole, BiRecurrent,
TimeDistributed).

One cell is applied over time with one parameter set, as the JAX
package scans one cell apply (``lax.scan``); here the steps are a
Python loop over T, each step a few small launches on the card.  The
reference's ``preTopology`` (Cell.scala:64-75) is kept: a cell's
``pre_apply`` computes the time-independent input projection of the
whole (N, T, F) sequence as one product before the loop, and the loop
does only the recurrent half.  No Pallas kernel computes any of this in
the JAX package, so these are plain PyTorch.

Layout: batch-first (N, T, F).  Hidden state is a ``Table`` where the
JAX package's is (LSTM, LSTMPeephole, ConvLSTMPeephole: (h, c)), a
tensor where its is (RnnCell, GRU).  Parameters carry the JAX names
(``i2h``, ``h2h``, ``bias``; ``peep_i``, ``peep_f``, ``peep_o``;
``wi``, ``wh``), and the containers' children its keys (``cell``;
``fwd``, ``bwd``, ``merge``; ``m``), so ``load_param_tree`` carries a
JAX model's weights.  Compute runs in the weights' dtype: each input is
cast to it before its product (the port's mixed-precision rule).
"""
from __future__ import annotations

import copy
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..device import DeviceLike
from ..utils.table import Table
from .initialization import ONE_D, RandomUniform
from .module import AbstractModule, Container


class Cell(AbstractModule):
    """Recurrent cell protocol (reference nn/Cell.scala:43).

    Subclasses implement:

    * ``init_hidden(batch_size, like)`` — the zero hidden state, on the
      device and in the dtype of the tensor ``like``;
    * ``pre_apply(params, x)`` — the time-independent projection of the
      whole (N, T, F) sequence (preTopology); the identity by default;
    * ``cell_apply(params, pre_t, hidden)`` — (out_t, new_hidden).

    As a layer on its own, a cell takes ``Table(x_t, hidden)`` and
    returns ``Table(out_t, new_hidden)``: one step."""

    def _uniform(self, name: str, shape, stdv: float,
                 generator: Optional[torch.Generator]):
        init = RandomUniform(-stdv, stdv)
        self._register_param(name, init.init(shape, ONE_D, generator), init,
                             ONE_D)

    def init_hidden(self, batch_size: int, like: torch.Tensor):
        raise NotImplementedError

    def pre_apply(self, params, x):
        return x

    def cell_apply(self, params, pre_t, hidden):
        raise NotImplementedError

    def _compute(self, params, inp):
        x_t, hidden = inp[1], inp[2]
        pre_t = self.pre_apply(params, x_t[:, None])[:, 0]
        out, new_hidden = self.cell_apply(params, pre_t, hidden)
        return Table(out, new_hidden)


def _project(x, w, b):
    """x (N, T, F) · wᵀ + b over the whole sequence, in w's dtype."""
    return torch.matmul(x.to(w.dtype), w.t()) + b


class RnnCell(Cell):
    """Vanilla RNN: h' = act(W x + U h + b) (reference nn/RnnCell.scala).
    ``activation`` is a function of a tensor, ``torch.tanh`` by
    default."""

    def __init__(self, input_size: int, hidden_size: int, activation=None,
                 *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device)
        self.input_size, self.hidden_size = input_size, hidden_size
        self.activation = activation if activation is not None else torch.tanh
        stdv = 1.0 / math.sqrt(hidden_size)
        self._uniform("i2h", (hidden_size, input_size), stdv, generator)
        self._uniform("h2h", (hidden_size, hidden_size), stdv, generator)
        self._uniform("bias", (hidden_size,), stdv, generator)

    def init_hidden(self, batch_size, like):
        return like.new_zeros((batch_size, self.hidden_size))

    def pre_apply(self, params, x):
        return _project(x, params["i2h"], params["bias"])

    def cell_apply(self, params, pre_t, h):
        h_new = self.activation(pre_t + h @ params["h2h"].t())
        return h_new, h_new


class LSTM(Cell):
    """LSTM cell (reference nn/LSTM.scala:50); gate order i, f, z (g), o,
    which is ``torch.nn.LSTM``'s.  ``p`` and the regularizers are kept
    for the reference's signature; the JAX cell applies no dropout."""

    def __init__(self, input_size: int, hidden_size: int, p: float = 0.0,
                 w_regularizer=None, u_regularizer=None, b_regularizer=None,
                 *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device)
        self.input_size, self.hidden_size = input_size, hidden_size
        self.p = p
        H, Fi = hidden_size, input_size
        stdv = 1.0 / math.sqrt(H)
        self._uniform("i2h", (4 * H, Fi), stdv, generator)
        self._uniform("h2h", (4 * H, H), stdv, generator)
        self._uniform("bias", (4 * H,), stdv, generator)

    def init_hidden(self, batch_size, like):
        z = like.new_zeros((batch_size, self.hidden_size))
        return Table(z, z)

    def pre_apply(self, params, x):
        return _project(x, params["i2h"], params["bias"])

    def cell_apply(self, params, pre_t, hidden):
        h, c = hidden[1], hidden[2]
        H = self.hidden_size
        gates = pre_t + h @ params["h2h"].t()
        i = torch.sigmoid(gates[:, 0:H])
        f = torch.sigmoid(gates[:, H:2 * H])
        z = torch.tanh(gates[:, 2 * H:3 * H])
        o = torch.sigmoid(gates[:, 3 * H:4 * H])
        c_new = f * c + i * z
        h_new = o * torch.tanh(c_new)
        return h_new, Table(h_new, c_new)


class LSTMPeephole(LSTM):
    """LSTM with peephole connections (reference nn/LSTMPeephole.scala):
    i and f see c, o sees the new c."""

    def __init__(self, input_size: int, hidden_size: int, p: float = 0.0,
                 *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_size, hidden_size, p, device=device,
                         generator=generator)
        stdv = 1.0 / math.sqrt(hidden_size)
        for name in ("peep_i", "peep_f", "peep_o"):
            self._uniform(name, (hidden_size,), stdv, generator)

    def cell_apply(self, params, pre_t, hidden):
        h, c = hidden[1], hidden[2]
        H = self.hidden_size
        gates = pre_t + h @ params["h2h"].t()
        i = torch.sigmoid(gates[:, 0:H] + params["peep_i"] * c)
        f = torch.sigmoid(gates[:, H:2 * H] + params["peep_f"] * c)
        z = torch.tanh(gates[:, 2 * H:3 * H])
        c_new = f * c + i * z
        o = torch.sigmoid(gates[:, 3 * H:4 * H] + params["peep_o"] * c_new)
        h_new = o * torch.tanh(c_new)
        return h_new, Table(h_new, c_new)


class GRU(Cell):
    """GRU cell (reference nn/GRU.scala:54); gate order r, z, n, and
    h' = (1 − z)·n + z·h, which is ``torch.nn.GRU``'s with its hidden
    bias at 0."""

    def __init__(self, input_size: int, hidden_size: int, p: float = 0.0,
                 *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device)
        self.input_size, self.hidden_size = input_size, hidden_size
        H, Fi = hidden_size, input_size
        stdv = 1.0 / math.sqrt(H)
        self._uniform("i2h", (3 * H, Fi), stdv, generator)
        self._uniform("h2h", (3 * H, H), stdv, generator)
        self._uniform("bias", (3 * H,), stdv, generator)

    def init_hidden(self, batch_size, like):
        return like.new_zeros((batch_size, self.hidden_size))

    def pre_apply(self, params, x):
        return _project(x, params["i2h"], params["bias"])

    def cell_apply(self, params, pre_t, h):
        H = self.hidden_size
        hh = h @ params["h2h"].t()
        r = torch.sigmoid(pre_t[:, 0:H] + hh[:, 0:H])
        z = torch.sigmoid(pre_t[:, H:2 * H] + hh[:, H:2 * H])
        n = torch.tanh(pre_t[:, 2 * H:3 * H] + r * hh[:, 2 * H:3 * H])
        h_new = (1 - z) * n + z * h
        return h_new, h_new


class ConvLSTMPeephole(Cell):
    """Convolutional LSTM with peepholes (reference
    nn/ConvLSTMPeephole.scala).  State maps are (N, C, H, W); the gates
    come from two SAME-padded 2-D convs (``F.conv2d``: the JAX cell's are
    ``lax.conv``, not the Pallas kernel), one of x_t and one of h.
    ``stride`` is kept for the reference's signature; the gates' convs
    run at stride 1."""

    def __init__(self, input_size: int, output_size: int, kernel_i: int,
                 kernel_c: int, stride: int = 1, with_peephole: bool = True,
                 *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device)
        self.input_size, self.output_size = input_size, output_size
        self.kernel_i, self.kernel_c = kernel_i, kernel_c
        self.with_peephole = with_peephole
        C_in, C_out = input_size, output_size
        stdv = 1.0 / math.sqrt(C_out * kernel_c * kernel_c)
        self._uniform("wi", (4 * C_out, C_in, kernel_i, kernel_i), stdv,
                      generator)
        self._uniform("wh", (4 * C_out, C_out, kernel_c, kernel_c), stdv,
                      generator)
        self._uniform("bias", (4 * C_out,), stdv, generator)
        if with_peephole:
            for name in ("peep_i", "peep_f", "peep_o"):
                self._uniform(name, (C_out,), stdv, generator)

    def init_hidden(self, batch_size, like):
        """Zero maps of the spatial size of ``like``, one step's input
        (N, C, H, W) or a sequence (N, T, C, H, W)."""
        z = like.new_zeros((batch_size, self.output_size)
                           + tuple(like.shape[-2:]))
        return Table(z, z)

    @staticmethod
    def _conv(x, w):
        pad = w.shape[-1] // 2
        return F.conv2d(x.to(w.dtype), w, None, 1, pad)

    def cell_apply(self, params, x_t, hidden):
        h, c = hidden[1], hidden[2]
        C = self.output_size
        gates = (self._conv(x_t, params["wi"]) + self._conv(h, params["wh"])
                 + params["bias"][None, :, None, None])
        gi = gates[:, 0:C]
        gf = gates[:, C:2 * C]
        gz = gates[:, 2 * C:3 * C]
        go = gates[:, 3 * C:4 * C]
        if self.with_peephole:
            gi = gi + params["peep_i"][None, :, None, None] * c
            gf = gf + params["peep_f"][None, :, None, None] * c
        i = torch.sigmoid(gi)
        f = torch.sigmoid(gf)
        z = torch.tanh(gz)
        c_new = f * c + i * z
        if self.with_peephole:
            go = go + params["peep_o"][None, :, None, None] * c_new
        o = torch.sigmoid(go)
        h_new = o * torch.tanh(c_new)
        return h_new, Table(h_new, c_new)


class _Wrapper(Container):
    """A container whose children sit under the JAX package's keys
    rather than "0", "1", …; the gradient scales are its children's
    (``Container``'s rule).  On its first child's device unless
    ``device`` is given; one built empty takes the device of the first
    cell it is given (``add``)."""

    def __init__(self, device: DeviceLike = None, **children):
        given = [m for m in children.values() if m is not None]
        if device is None and given:
            device = given[0].device
        # an empty wrapper holds nothing until ``add`` names its device
        super().__init__(device=device if device is not None else "cpu")
        for key, m in children.items():
            if m is not None:
                self.add_module(key, m)


class Recurrent(_Wrapper):
    """Sequence container: one cell over time (reference
    nn/Recurrent.scala:32).  Input (N, T, F) → output (N, T, H); with
    ``reverse`` the sequence runs from its last step, and the outputs
    come back in input order."""

    def __init__(self, cell: Optional[Cell] = None, reverse: bool = False,
                 device: DeviceLike = None):
        super().__init__(device, cell=cell)
        self.reverse = reverse

    def add(self, cell: Cell):
        self.add_module("cell", cell)
        self._device = cell.device
        return self

    def apply_fn(self, params, x):
        cell, cp = self.cell, params["cell"]
        if isinstance(cell, ConvLSTMPeephole):
            pre = x.to(cp["wi"].dtype)
        else:
            pre = cell.pre_apply(cp, x)
        hidden = cell.init_hidden(x.shape[0], pre)
        steps = range(pre.shape[1])
        if self.reverse:
            steps = reversed(steps)
        outs = [None] * pre.shape[1]
        for t in steps:
            outs[t], hidden = cell.cell_apply(cp, pre[:, t], hidden)
        return torch.stack(outs, dim=1)


class BiRecurrent(_Wrapper):
    """Bidirectional recurrent (reference nn/BiRecurrent.scala): a
    forward and a reversed ``Recurrent`` on the same input, merged by
    elementwise addition or by ``merge`` applied to ``Table(fwd, bwd)``.
    ``add(cell)`` makes the backward cell a copy of ``cell`` re-drawn
    from ``generator``."""

    def __init__(self, merge: Optional[AbstractModule] = None,
                 device: DeviceLike = None):
        super().__init__(device, merge=merge)

    def add(self, cell: Cell, generator: Optional[torch.Generator] = None):
        # children in the JAX tree's order: fwd, bwd, merge
        merge = self._modules.pop("merge", None)
        self._device = cell.device
        self.add_module("fwd", Recurrent(cell))
        self.add_module("bwd", Recurrent(copy.deepcopy(cell).reset(generator),
                                         reverse=True))
        if merge is not None:
            self.add_module("merge", merge)
        return self

    def apply_fn(self, params, x):
        fo = self.fwd.apply_fn(params["fwd"], x)
        bo = self.bwd.apply_fn(params["bwd"], x)
        merge = self._modules.get("merge")
        if merge is None:
            return fo + bo
        return merge.apply_fn(params["merge"], Table(fo, bo))


class TimeDistributed(_Wrapper):
    """A module at every step (reference nn/TimeDistributed.scala): T
    folded into the batch dim, one batched apply, no loop.  The module
    is the child ``m`` (the JAX key; ``module`` reads it too)."""

    def __init__(self, module: AbstractModule, device: DeviceLike = None):
        super().__init__(device if device is not None else module.device,
                         m=module)

    def apply_fn(self, params, x):
        n, t = x.shape[0], x.shape[1]
        out = self.m.apply_fn(params["m"],
                                   x.reshape((n * t,) + tuple(x.shape[2:])))
        return out.reshape((n, t) + tuple(out.shape[1:]))

    @property
    def module(self) -> AbstractModule:
        return self.m
