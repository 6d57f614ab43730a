"""The Torch-style API's layer, criterion and Tensor cases, built on
either device, for holding the card against the CPU: each class ported
with the module verbs (the JAX package's activations, shape_ops,
table_ops, containers, linear, normalization, criterion and dropout
modules, less what earlier slices ported) at the shapes of its CPU
test.  ``chip_smoke.py`` (phase 11 (d)) and the card tests of
``tests/test_torch_cuda.py`` read them.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import nn
from .. import tensor as P
from ..nn.module import activity_leaves, activity_map
from ..ops import conv3x3
from .table import Table

#: card against CPU in f32: each output and gradient within this share
#: of its largest value (summation order only)
ZOO_REL_TOL = 1e-5


class _T:
    """A Table of numpy inputs for the sweep, built on either device."""

    def __init__(self, *items):
        self.items = items


def to_device(x, dev):
    """A case's input (numpy, or ``_T`` of them) as tensors on ``dev``."""
    if isinstance(x, _T):
        return Table(*(to_device(v, dev) for v in x.items))
    return torch.as_tensor(x).to(dev)


def zoo_cases():
    """(name, make(device), input, target or None, train) for every
    layer and criterion class ported with the Torch-style API (the
    JAX package's activations, shape_ops, table_ops, containers, linear,
    normalization, criterion and dropout modules, less what earlier
    slices ported), at the shapes of ``tests/test_torch_layer_zoo.py``
    and ``tests/test_torch_criterions.py``; numpy inputs from
    ``RandomState(7)``.  ``train``: the random layers (RReLU, Dropout)
    run in eval mode against the CPU and are checked in training mode
    on the card alone."""
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
    LOGP = np.log(R.rand(3, 5).astype(np.float32) + 0.05)
    LOGITS = R.randn(3, 5).astype(np.float32)
    LABELS = np.array([2., 5., 1.], np.float32)
    PROBS = (R.rand(3, 5).astype(np.float32) * 0.8 + 0.1)
    BIN = (R.rand(3, 5) > 0.5).astype(np.float32)
    PM1 = np.array([1., -1., 1.], np.float32)
    MLM = np.array([[2, 4, 0, 0, 0], [1, 0, 0, 0, 0], [3, 5, 1, 0, 0]],
                   np.float32)

    def layer(name, *args, **kw):
        return lambda dev: getattr(nn, name)(*args, **kw, device=dev)

    def crit(name, *args, **kw):
        return lambda dev: getattr(nn, name)(*args, **kw)

    def wrap(name, *children):
        return lambda dev: getattr(nn, name)(
            *(getattr(nn, c)(*a, device=dev) for c, a in children),
            device=dev)

    def combo(name, parts, **kw):
        def make(dev):
            c = getattr(nn, name)(**kw)
            for cls, w in parts:
                c.add(getattr(nn, cls)(), w)
            return c
        return make

    L = [
        ("ReLU6", layer("ReLU6"), 4 * X),
        ("LeakyReLU", layer("LeakyReLU", .1), X),
        ("PReLU", layer("PReLU", 3), X4), ("RReLU", layer("RReLU", .2, .4), X),
        ("ELU", layer("ELU", .7), X), ("Sigmoid", layer("Sigmoid"), X),
        ("LogSigmoid", layer("LogSigmoid"), X),
        ("SoftMax", layer("SoftMax"), X),
        ("SoftMin", layer("SoftMin"), X), ("SoftPlus", layer("SoftPlus"), X),
        ("SoftSign", layer("SoftSign"), X),
        ("HardTanh", layer("HardTanh", -.5, .5), X),
        ("HardShrink", layer("HardShrink", .5), X),
        ("SoftShrink", layer("SoftShrink", .5), X),
        ("TanhShrink", layer("TanhShrink"), X),
        ("Threshold", layer("Threshold", .2, -1.), X),
        ("Clamp", layer("Clamp", -.5, .5), X), ("Abs", layer("Abs"), XP),
        ("Power", layer("Power", 2., 1.5, .1), XP),
        ("Square", layer("Square"), X),
        ("Sqrt", layer("Sqrt"), XP), ("Log", layer("Log"), XP),
        ("Exp", layer("Exp"), X), ("Mean", layer("Mean", 2), X),
        ("Sum", layer("Sum", 2, size_average=True), X),
        ("Max", layer("Max", 2), X), ("Min", layer("Min", 2), X),
        ("InferReshape", layer("InferReshape", [4, 6]), X234),
        ("Transpose", layer("Transpose", [(2, 3), (1, 2)]), X3),
        ("Replicate", layer("Replicate", 3, 2), X),
        ("Squeeze", layer("Squeeze", 2), X134),
        ("Unsqueeze", layer("Unsqueeze", 2), X),
        ("Select", layer("Select", 2, -1), X),
        ("Narrow", layer("Narrow", 2, 2, 3), X),
        ("SelectTable", layer("SelectTable", 2), _T(X, X2)),
        ("NarrowTable", layer("NarrowTable", 1, 2), _T(X, X2, XP)),
        ("FlattenTable", layer("FlattenTable"), _T(X, _T(X2, XP))),
        ("SplitTable", layer("SplitTable", 2), X3),
        ("JoinTable", layer("JoinTable", 2, 2), _T(X, X2)),
        ("Pack", layer("Pack", 2), _T(X, X2)),
        ("Reverse", layer("Reverse", 2), X),
        ("Contiguous", layer("Contiguous"), X),
        ("Index", layer("Index", 1), _T(X, np.array([2., 1.], np.float32))),
        ("MaskedSelect", layer("MaskedSelect"),
         _T(X, (X2 > 0).astype(np.float32))),
        ("Padding", layer("Padding", 2, -2, 2, .5), X),
        ("SpatialZeroPadding", layer("SpatialZeroPadding", 1, 2, 0, 1), X4),
        ("DotProduct", layer("DotProduct"), _T(X, X2)),
        ("CosineDistance", layer("CosineDistance"), _T(X, X2)),
        ("PairwiseDistance", layer("PairwiseDistance"), _T(X, X2)),
        ("MixtureTable", layer("MixtureTable"), _T(GATE, _T(X, X2))),
        ("Scale", layer("Scale", [1, 6]), X),
        ("GradientReversal", layer("GradientReversal", .7), X),
        ("CSubTable", layer("CSubTable"), _T(X, X2)),
        ("CMulTable", layer("CMulTable"), _T(X, X2)),
        ("CDivTable", layer("CDivTable"), _T(XP, XP + .5)),
        ("CMaxTable", layer("CMaxTable"), _T(X, X2)),
        ("CMinTable", layer("CMinTable"), _T(X, X2)),
        ("ParallelTable", wrap("ParallelTable", ("Linear", (6, 4)),
                               ("Tanh", ())), _T(X, X2)),
        ("MapTable", wrap("MapTable", ("Linear", (6, 4))), _T(X, X2)),
        ("Bottle", wrap("Bottle", ("Linear", (6, 4))), X3),
        ("Echo", layer("Echo"), X),
        ("Bilinear", layer("Bilinear", 5, 4, 3),
         _T(R.randn(3, 5).astype(np.float32),
            R.randn(3, 4).astype(np.float32))),
        ("CMul", layer("CMul", [6]), X), ("CAdd", layer("CAdd", [6]), X),
        ("Mul", layer("Mul"), X), ("Add", layer("Add", 6), X),
        ("AddConstant", layer("AddConstant", 2.5), X),
        ("MM", layer("MM"), _T(MM_A, MM_B)),
        ("MV", layer("MV"), _T(MM_B, R.randn(2, 5).astype(np.float32))),
        ("Cosine", layer("Cosine", 6, 4), X),
        ("Euclidean", layer("Euclidean", 6, 3), X),
        ("SpatialCrossMapLRN", layer("SpatialCrossMapLRN"), X4),
        ("Normalize", layer("Normalize", 2.), X),
        ("L1Penalty", layer("L1Penalty", .3), X),
        ("SpatialSubtractiveNormalization",
         layer("SpatialSubtractiveNormalization", 3), X4),
        ("SpatialDivisiveNormalization",
         layer("SpatialDivisiveNormalization", 3), X4),
        ("SpatialContrastiveNormalization",
         layer("SpatialContrastiveNormalization", 3), X4),
        ("ImageNormalize", layer("ImageNormalize", (.4, .5, .6),
                                 (.2, .25, .3)), NHWC),
        ("Dropout", layer("Dropout", .5), X),
    ]
    C = [
        ("MSECriterion", crit("MSECriterion"), X, X2),
        ("AbsCriterion", crit("AbsCriterion"), X, X2),
        ("BCECriterion", crit("BCECriterion"), PROBS, BIN),
        ("SmoothL1Criterion", crit("SmoothL1Criterion"), X, X2),
        ("SmoothL1CriterionWithWeights",
         crit("SmoothL1CriterionWithWeights", sigma=1., num=3), X,
         _T(X2, np.ones_like(X), np.ones_like(X))),
        ("MarginCriterion", crit("MarginCriterion"), X[:, 0] * .4, PM1),
        ("MarginRankingCriterion", crit("MarginRankingCriterion", .7),
         _T(X[:, 0], X2[:, 0]), PM1),
        ("MultiMarginCriterion", crit("MultiMarginCriterion"), LOGITS, LABELS),
        ("MultiLabelMarginCriterion", crit("MultiLabelMarginCriterion"),
         LOGITS, MLM),
        ("MultiLabelSoftMarginCriterion",
         crit("MultiLabelSoftMarginCriterion"), LOGITS, BIN),
        ("HingeEmbeddingCriterion", crit("HingeEmbeddingCriterion", 2.),
         np.abs(X[:, 0]) + .3, PM1),
        ("L1HingeEmbeddingCriterion", crit("L1HingeEmbeddingCriterion", 5.),
         _T(X[0], X2[0]), np.float32(-1.)),
        ("CosineEmbeddingCriterion", crit("CosineEmbeddingCriterion", .2),
         _T(X, X2), PM1),
        ("CosineDistanceCriterion", crit("CosineDistanceCriterion"), X, X2),
        ("DistKLDivCriterion", crit("DistKLDivCriterion"), LOGP, PROBS),
        ("ClassSimplexCriterion", crit("ClassSimplexCriterion", 5), LOGITS,
         LABELS),
        ("DiceCoefficientCriterion", crit("DiceCoefficientCriterion"),
         PROBS, BIN),
        ("L1Cost", crit("L1Cost"), XP, XP),
        ("SoftMarginCriterion", crit("SoftMarginCriterion"), X,
         (2 * (R.rand(3, 6) > .5) - 1).astype(np.float32)),
        ("SoftmaxWithCriterion", crit("SoftmaxWithCriterion"),
         R.randn(2, 5, 3, 3).astype(np.float32),
         R.randint(1, 6, (2, 1, 3, 3)).astype(np.float32)),
        ("ParallelCriterion", combo("ParallelCriterion",
                                    [("MSECriterion", .5),
                                     ("AbsCriterion", 2.)]),
         _T(X, X2), _T(X2, X)),
        ("MultiCriterion", combo("MultiCriterion", [("MSECriterion", .5),
                                                    ("AbsCriterion", 2.)]),
         X, X2),
    ]
    return ([(n, m, x, None, n in ("RReLU", "Dropout")) for n, m, x in L]
            + [(n, m, x, t, False) for n, m, x, t in C])


def zoo_tail_cases():
    """(name, make(device), input, None, False) for every class of the
    image and sequence zoo that phase 13 (a)-(c) do not train: the conv
    and pooling tail, the recurrent stack's cells and containers, the
    Tree-LSTM, the TF ops, a graph, ``Autoencoder`` and
    ``VggForCifar10``, at the shapes of their CPU tests
    (``tests/test_torch_{conv_tail,recurrent,tree_tf,graph,zoo_models}
    .py``); numpy inputs from ``RandomState(8)``.  ``chip_smoke.py``
    (phase 13 (d)) and ``tests/test_torch_cuda.py`` hold each on the
    card against the CPU, as ``zoo_cases``."""
    from .. import models

    R = np.random.RandomState(8)
    X4 = R.randn(2, 4, 7, 6).astype(np.float32)
    X5 = R.randn(2, 2, 5, 6, 7).astype(np.float32)
    SEQ = R.randn(2, 5, 6).astype(np.float32)
    MAPS = R.randn(2, 3, 3, 5, 5).astype(np.float32)
    TOKENS = R.randn(2, 3, 4).astype(np.float32)
    TREES = np.array([[[2, 3, -1], [0, 0, 1], [4, 5, 0], [0, 0, 2],
                       [0, 0, 3], [-1, -1, 0]]] * 2, np.float32)
    ROIS = np.array([[1, 0, 0, 5, 4], [2, 1.5, 2.5, 6, 6],
                     [1, 9, 9, 12, 12]], np.float32)
    CONN = [[1, 1], [2, 1], [2, 2], [3, 2], [4, 3], [1, 3]]

    def layer(name, *args, **kw):
        return lambda dev: getattr(nn, name)(*args, **kw, device=dev)

    def seeded(make):
        return lambda dev: make(dev, torch.Generator().manual_seed(0))

    def recurrent(cell, *args, reverse=False):
        return lambda dev: nn.Recurrent(getattr(nn, cell)(*args, device=dev),
                                        reverse=reverse)

    def birecurrent(merge):
        def make(dev):
            m = nn.BiRecurrent(None if merge is None
                               else nn.JoinTable(3, device=dev))
            return m.add(nn.LSTM(6, 4, device=dev),
                         torch.Generator().manual_seed(1))
        return make

    def diamond(dev):
        inp = nn.Input(device=dev)
        l1 = nn.Linear(6, 6, device=dev)(inp)
        add = nn.CAddTable(device=dev)([nn.ReLU(device=dev)(l1),
                                        nn.Tanh(device=dev)(l1)])
        return nn.Graph(inp, nn.Linear(6, 3, device=dev)(add))

    L = [
        ("SpatialShareConvolution",
         layer("SpatialShareConvolution", 4, 5, 3, 3, 1, 1, 1, 1), X4),
        ("SpatialDilatedConvolution",
         layer("SpatialDilatedConvolution", 4, 5, 3, 3, 1, 1, 2, 2, 2, 2),
         X4),
        ("SpatialFullConvolution",
         layer("SpatialFullConvolution", 4, 6, 3, 3, 2, 2, 1, 1, 1, 1,
               n_group=2), X4),
        ("SpatialConvolutionMap",
         layer("SpatialConvolutionMap", CONN, 3, 3, 1, 1, 1, 1), X4),
        ("TemporalConvolution", layer("TemporalConvolution", 6, 4, 3, 2),
         SEQ),
        ("VolumetricConvolution",
         layer("VolumetricConvolution", 2, 3, 2, 3, 3, 1, 2, 1, 1, 1, 0),
         X5),
        ("VolumetricMaxPooling",
         layer("VolumetricMaxPooling", 3, 3, 2, 2, 2, 1, 1, 1, 0), X5),
        ("RoiPooling", layer("RoiPooling", 3, 2, 0.5), _T(X4, ROIS)),
        ("Recurrent(RnnCell)", recurrent("RnnCell", 6, 4), SEQ),
        ("Recurrent(LSTM)", recurrent("LSTM", 6, 4), SEQ),
        ("Recurrent(LSTMPeephole) reversed",
         recurrent("LSTMPeephole", 6, 4, reverse=True), SEQ),
        ("Recurrent(GRU)", recurrent("GRU", 6, 4), SEQ),
        ("Recurrent(ConvLSTMPeephole)",
         recurrent("ConvLSTMPeephole", 3, 4, 3, 3), MAPS),
        ("BiRecurrent", birecurrent(None), SEQ),
        ("BiRecurrent(JoinTable)", birecurrent("join"), SEQ),
        ("TimeDistributed", lambda dev: nn.TimeDistributed(
            nn.Linear(6, 4, device=dev)), SEQ),
        ("LSTM step", layer("LSTM", 6, 4),
         _T(SEQ[:, 0], _T(SEQ[:, 1, :4], SEQ[:, 2, :4]))),
        ("BinaryTreeLSTM", layer("BinaryTreeLSTM", 4, 3),
         _T(TOKENS, TREES)),
        ("TreeLSTM", layer("TreeLSTM", 4, 3, gate_output=False),
         _T(TOKENS, TREES)),
        ("Const", layer("Const", np.arange(6.0).reshape(2, 3)), SEQ),
        ("Fill", layer("Fill", 2.5), np.array([2.0, 3.0], np.float32)),
        ("Shape", layer("Shape"), X5),
        ("SplitAndSelect", layer("SplitAndSelect", 3, 2, 3), SEQ),
        ("StrideSlice", layer("StrideSlice", [(1, 1, 2, 1), (3, 2, 5, 1)]),
         SEQ),
        ("Graph", diamond, SEQ[:, 0]),
        ("Autoencoder", seeded(lambda dev, g: models.Autoencoder(
            16, device=dev, generator=g)),
         R.rand(2, 28, 28).astype(np.float32)),
        ("VggForCifar10", seeded(lambda dev, g: models.VggForCifar10(
            10, device=dev, generator=g)),
         R.rand(2, 3, 32, 32).astype(np.float32)),
    ]
    return [(n, m, x, None, False) for n, m, x in L]


def rel_err(got, want) -> float:
    """max |got - want| / max |want| in f32 (0 when both are 0)."""
    g, w = got.detach().float().cpu(), want.detach().float().cpu()
    if g.shape != w.shape:
        return float("inf")
    if w.numel() == 0:
        return 0.0
    scale = w.abs().max().item()
    err = (g - w).abs().max().item()
    return err / scale if scale > 0 else err


def conv3x3_yardstick(x, w):
    """What K5's output on the card is held to: the plain version
    (``x`` NHWC, ``w`` HWIO), except where its rows (one pixel's output
    channels) are shorter than 16 in bf16.  Two bf16 roundings of the
    same f32 sum may land on neighbouring values, one bf16 step up to
    2^-7 of the element, which in a row of a few elements is that much
    of the whole row (the row limits assume rows of 16 or more, as the
    attention checks do); such rows are held to the plain version's f32
    sum before its rounding."""
    if x.dtype == torch.bfloat16 and w.shape[-1] < 16:
        return conv3x3._conv3x3_plain(x.float(), w.float())
    return conv3x3._conv3x3_plain(x, w)


def zoo_case_on(case, dev, module=None):
    """One case's output, input gradient and parameter gradients on
    ``dev``: the verbs ``forward`` then ``backward`` of a seeded output
    gradient (a criterion's ``forward`` and ``backward``).  ``module``:
    the CPU case's module, cloned to ``dev`` (the same weights)."""
    name, make, inp, target, _ = case
    x = to_device(inp, dev)
    if target is not None:
        c = make(dev)
        t = to_device(target, dev)
        loss = c.forward(x, t)
        gi = c.backward(x, t)
        gi = activity_leaves(gi)
        return ([torch.tensor(loss)], gi, [],
                activity_leaves(x) + activity_leaves(t) + gi, c)
    m = (make(dev) if module is None
         else module.clone_module()._place(torch.device(dev)))
    m.evaluate()
    out = m.forward(x)
    rng = np.random.RandomState(0)
    go = activity_map(lambda o: torch.as_tensor(rng.standard_normal(
        tuple(o.shape)).astype(np.float32)).to(dev), out)
    m.zero_grad_parameters()
    gi = m.backward(x, go)
    grads = [p.grad for p in m.parameters()]
    out, gi = activity_leaves(out), activity_leaves(gi)
    return out, gi, grads, out + gi, m


def tensor_ops(dev):
    """The Tensor facade's ops on ``dev``, each result as a CPU tensor."""
    rng = np.random.RandomState(5)
    a = rng.randn(4, 6).astype(np.float32)
    b = rng.randn(6, 3).astype(np.float32)
    c = rng.randn(4, 3).astype(np.float32)
    v = rng.randn(6).astype(np.float32)
    t = P.tensor(a, device=dev)
    out = {}
    out["select"] = t.select(1, 2).data
    out["narrow"] = t.narrow(2, 2, 3).data
    out["transpose"] = t.transpose(1, 2).contiguous().data
    out["view"] = t.view(6, 4).data
    out["addmm"] = P.tensor(c, device=dev).addmm(
        0.5, P.tensor(c, device=dev), 2.0, t, P.tensor(b, device=dev)).data
    out["addmv"] = P.tensor(a[:, 0], device=dev).addmv(
        0.5, 2.0, t, P.tensor(v, device=dev)).data
    vals, idx = t.max(2)
    out["max"], out["max_idx"] = vals.data, idx.data
    vals, idx = t.min(1)
    out["min"], out["min_idx"] = vals.data, idx.data
    vals, idx = t.topk(3, 2)
    out["topk"], out["topk_idx"] = vals.data, idx.data
    out["sum"] = t.sum(2).data
    out["unfold"] = P.tensor(v, device=dev).unfold(1, 3, 2).data
    out["gather"] = t.gather(2, P.tensor(np.array([[1., 3.]] * 4),
                                         device=dev)).data
    s = P.tensor(a, device=dev).scatter(
        2, P.tensor(np.array([[1., 2.]] * 4), device=dev),
        P.tensor(np.ones((4, 2)), device=dev))
    out["scatter"] = s.data
    f = P.ones(2, 3, device=dev)
    f.zero()
    f.copy(P.tensor(c[:2], device=dev))
    out["fill_zero_copy"] = f.data
    out["axpy"] = P.tensor(a, device=dev).axpy(2.0, t).data
    out["bf16"] = t.to_bf16().to_f32().data
    on_card = all(x.device.type == torch.device(dev).type
                  for x in out.values())
    return {k: x.cpu() for k, x in out.items()}, on_card
