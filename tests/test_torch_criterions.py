"""The port's criterions (bigdl_tpu_torch.nn) against the JAX package's,
in f32 on the CPU: one case per class of ``bigdl_tpu/nn/criterion.py``,
the loss of ``forward`` and the input gradient of ``backward`` on the
same numpy inputs made from a seed.

The inputs are those of ``tests/test_gradient_value_sweep.py``'s
criterion cases; the semantic cases mirror ``tests/test_criterion_oracle.py``
and the criterion cases of ``tests/test_layer_zoo_sweep.py``.  Where
those hold the JAX package against a float64 torch oracle, these hold
the port against the JAX package in f32 (JAX runs without x64 here), at
``TOL``.  Class labels are 1-based in both packages.
"""
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bigdl_tpu import nn as jnn
from bigdl_tpu_torch import nn as tnn

from test_torch_layer_zoo import T, leaves, to_jax, to_port

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-6)


def run_pair(jc, pc, inp, target, tol=TOL):
    """Both criterions' loss and input gradient, held at ``tol``."""
    want = jc.forward(to_jax(inp), to_jax(target))
    got = pc.forward(to_port(inp), to_port(target))
    np.testing.assert_allclose(got, want, **tol)
    gi_want = jc.backward(to_jax(inp), to_jax(target))
    gi_got = pc.backward(to_port(inp), to_port(target))
    for g, w in zip(leaves(gi_got), leaves(gi_want), strict=True):
        np.testing.assert_allclose(g, w, **tol)
    return got


R = np.random.RandomState(7)
X = R.randn(3, 6).astype(np.float32)
X2 = R.randn(3, 6).astype(np.float32)
XP = (R.rand(3, 6) + 0.2).astype(np.float32)
X3 = R.randn(2, 5, 6).astype(np.float32)
Y3 = R.randn(2, 5, 6).astype(np.float32)
LOGP = np.log(np.abs(R.rand(3, 5)).astype(np.float32)
              / np.abs(R.rand(3, 5) + 1).astype(np.float32).sum())
LOGITS = R.randn(3, 5).astype(np.float32)
LABELS = np.array([2., 5., 1.], np.float32)
PROBS = (R.rand(3, 5).astype(np.float32) * 0.8 + 0.1)
BIN = (R.rand(3, 5) > 0.5).astype(np.float32)
PM1 = np.array([1., -1., 1.], np.float32)
SIGNS = (2 * (R.rand(3, 6) > 0.5) - 1).astype(np.float32)
SEG = R.randn(2, 5, 3, 3).astype(np.float32)
SEG_LABELS = R.randint(1, 6, (2, 1, 3, 3)).astype(np.float32)
MLM = np.array([[2, 4, 0, 0, 0], [1, 0, 0, 0, 0], [3, 5, 1, 0, 0]],
               np.float32)
CLS_W = np.array([0.2, 0.5, 1.0, 2.0, 0.7], np.float32)


def both(name, *args, **kw):
    return (lambda: getattr(jnn, name)(*args, **kw),
            lambda: getattr(tnn, name)(*args, **kw))


def weighted(name, weights, **kw):
    return (lambda: getattr(jnn, name)(weights=jnp.asarray(weights), **kw),
            lambda: getattr(tnn, name)(weights=weights, **kw))


def combo(name, parts, **kw):
    """A ParallelCriterion/MultiCriterion over (class name, args,
    weight) parts."""
    def make(pkg):
        c = getattr(pkg, name)(**kw)
        for cls, args, w in parts:
            c.add(getattr(pkg, cls)(*args), w)
        return c
    return (lambda: make(jnn), lambda: make(tnn))


# name -> ((make JAX criterion, make port criterion), input, target)
CRITERION_CASES = {
    "AbsCriterion": (both("AbsCriterion"), X, X2),
    "BCECriterion": (both("BCECriterion"), PROBS, BIN),
    "ClassNLLCriterion": (both("ClassNLLCriterion"), LOGP, LABELS),
    "ClassSimplexCriterion": (both("ClassSimplexCriterion", 5), LOGITS,
                              LABELS),
    "CosineDistanceCriterion": (both("CosineDistanceCriterion"), X, X2),
    "CosineEmbeddingCriterion": (both("CosineEmbeddingCriterion", 0.2),
                                 T(X, X2), PM1),
    "CrossEntropyCriterion": (both("CrossEntropyCriterion"), LOGITS,
                              LABELS),
    "DiceCoefficientCriterion": (both("DiceCoefficientCriterion"), PROBS,
                                 BIN),
    "DistKLDivCriterion": (both("DistKLDivCriterion"), LOGP, PROBS),
    "HingeEmbeddingCriterion": (both("HingeEmbeddingCriterion", 2.0),
                                np.abs(X[:, 0]) + 0.3, PM1),
    "L1Cost": (both("L1Cost"), XP, XP),
    "L1HingeEmbeddingCriterion": (both("L1HingeEmbeddingCriterion", 5.0),
                                  T(X[0], X2[0]), np.float32(-1.0)),
    "MSECriterion": (both("MSECriterion"), X, X2),
    "MarginCriterion": (both("MarginCriterion"), X[:, 0] * 0.4, PM1),
    "MarginRankingCriterion": (both("MarginRankingCriterion", 0.7),
                               T(X[:, 0], X2[:, 0]), PM1),
    "MultiCriterion": (combo("MultiCriterion", [("MSECriterion", (), 0.5),
                                                ("AbsCriterion", (), 2.0)]),
                       X, X2),
    "MultiLabelMarginCriterion": (both("MultiLabelMarginCriterion"),
                                  LOGITS, MLM),
    "MultiLabelSoftMarginCriterion": (both("MultiLabelSoftMarginCriterion"),
                                      LOGITS, BIN),
    "MultiMarginCriterion": (both("MultiMarginCriterion"), LOGITS, LABELS),
    "ParallelCriterion": (combo("ParallelCriterion",
                                [("MSECriterion", (), 0.5),
                                 ("ClassNLLCriterion", (), 1.0)]),
                          T(X, LOGP), T(X2, LABELS)),
    "SmoothL1Criterion": (both("SmoothL1Criterion"), X, X2),
    "SmoothL1CriterionWithWeights": (
        both("SmoothL1CriterionWithWeights", sigma=1.0, num=3), X,
        T(X2, np.ones_like(X), np.ones_like(X))),
    "SoftMarginCriterion": (both("SoftMarginCriterion"), X, SIGNS),
    "SoftmaxWithCriterion": (both("SoftmaxWithCriterion"), SEG, SEG_LABELS),
    "TimeDistributedCriterion": (
        (lambda: jnn.TimeDistributedCriterion(jnn.MSECriterion(), True),
         lambda: tnn.TimeDistributedCriterion(tnn.MSECriterion(), True)),
        X3, Y3),
}


@pytest.mark.parametrize("name", sorted(CRITERION_CASES))
def test_port_criterion_matches_jax(name):
    (make_j, make_p), inp, target = CRITERION_CASES[name]
    run_pair(make_j(), make_p(), inp, target)


def test_every_criterion_has_a_port_case():
    from bigdl_tpu.nn import criterion as jc

    names = sorted(n for n, c in vars(jc).items()
                   if inspect.isclass(c) and c.__module__ == jc.__name__
                   and issubclass(c, jc.AbstractCriterion)
                   and n != "AbstractCriterion")
    assert len(names) == 25
    missing = sorted(set(names) - set(CRITERION_CASES))
    assert not missing, f"no port case for {missing}"
    assert all(hasattr(tnn, n) for n in names)


# --------------------------------------------------------------------------
# size_average, weights and the batch reductions (test_criterion_oracle.py)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,inp,target", [
    ("MSECriterion", X, X2), ("AbsCriterion", X, X2),
    ("SmoothL1Criterion", X, X2), ("SoftMarginCriterion", X, SIGNS),
    ("MarginCriterion", X[:, 0], PM1), ("BCECriterion", PROBS, BIN),
    ("HingeEmbeddingCriterion", np.abs(X[:, 0]), PM1),
    ("MultiMarginCriterion", LOGITS, LABELS),
    ("MultiLabelMarginCriterion", LOGITS, MLM),
    ("MultiLabelSoftMarginCriterion", LOGITS, BIN),
    ("CosineDistanceCriterion", X, X2), ("DistKLDivCriterion", LOGP, PROBS),
    ("DiceCoefficientCriterion", PROBS, BIN),
    ("ClassNLLCriterion", LOGP, LABELS)])
def test_size_average_false_sums(name, inp, target):
    run_pair(getattr(jnn, name)(size_average=False),
             getattr(tnn, name)(size_average=False), inp, target)


@pytest.mark.parametrize("name,inp", [
    ("ClassNLLCriterion", LOGP), ("CrossEntropyCriterion", LOGITS),
    ("MultiMarginCriterion", LOGITS)])
def test_class_weights(name, inp):
    make_j, make_p = weighted(name, CLS_W)
    run_pair(make_j(), make_p(), inp, LABELS)


def test_bce_and_multilabel_soft_margin_element_weights():
    w = (R.rand(5) + 0.5).astype(np.float32)
    for name, inp in (("BCECriterion", PROBS),
                      ("MultiLabelSoftMarginCriterion", LOGITS)):
        make_j, make_p = weighted(name, w)
        run_pair(make_j(), make_p(), inp, BIN)


def test_single_sample_inputs():
    run_pair(jnn.ClassNLLCriterion(), tnn.ClassNLLCriterion(), LOGP[0],
             np.float32(3))
    run_pair(jnn.MultiMarginCriterion(), tnn.MultiMarginCriterion(),
             LOGITS[0], np.float32(2))
    run_pair(jnn.MultiLabelMarginCriterion(),
             tnn.MultiLabelMarginCriterion(), LOGITS[2], MLM[2])


def test_multilabel_margin_list_ends_at_its_first_zero():
    """1-based labels padded with 0 (the reference's encoding; torch's is
    0-based with -1)."""
    got = tnn.MultiLabelMarginCriterion().forward(
        torch.as_tensor(LOGITS), torch.as_tensor(MLM))
    want = torch.nn.functional.multilabel_margin_loss(
        torch.as_tensor(LOGITS), torch.as_tensor(MLM).long() - 1)
    np.testing.assert_allclose(got, float(want), rtol=1e-6)
    cut = MLM.copy()
    cut[0, 2:] = [0, 3, 0]           # the 3 after the 0 is not a label
    np.testing.assert_allclose(
        tnn.MultiLabelMarginCriterion().forward(torch.as_tensor(LOGITS),
                                                torch.as_tensor(cut)),
        got, rtol=1e-6)


def test_time_distributed_cross_entropy_matches_jax():
    logits = R.randn(2, 4, 7).astype(np.float32)
    labels = R.randint(1, 8, (2, 4)).astype(np.float32)
    for avg in (True, False):
        run_pair(jnn.TimeDistributedCriterion(jnn.CrossEntropyCriterion(),
                                              avg),
                 tnn.TimeDistributedCriterion(tnn.CrossEntropyCriterion(),
                                              avg), logits, labels)


def test_softmax_with_criterion_ignore_label_255():
    """Caffe's segmentation ignore label: the 255 pixel leaves the loss
    and the VALID count (SoftmaxWithCriterion.scala:72)."""
    logits = R.randn(1, 4, 2, 2).astype(np.float32)
    labels = np.array([[[[1, 255], [3, 2]]]], np.float32)
    got = run_pair(jnn.SoftmaxWithCriterion(ignore_label=255),
                   tnn.SoftmaxWithCriterion(ignore_label=255), logits, labels)
    want = torch.nn.functional.cross_entropy(
        torch.as_tensor(logits),
        torch.as_tensor(labels.reshape(1, 2, 2)).long() - 1,
        ignore_index=254)
    np.testing.assert_allclose(got, float(want), rtol=1e-5)


@pytest.mark.parametrize("mode", ["VALID", "FULL", "BATCH_SIZE", "NONE"])
def test_softmax_with_criterion_normalize_modes(mode):
    run_pair(jnn.SoftmaxWithCriterion(normalize_mode=mode),
             tnn.SoftmaxWithCriterion(normalize_mode=mode), SEG, SEG_LABELS)


def test_softmax_with_criterion_out_of_range_raises_on_the_host():
    logits = torch.as_tensor(R.randn(4, 3).astype(np.float32))
    labels = torch.as_tensor([0., 1., 2., 3.])
    with pytest.raises(ValueError, match="1-based"):
        tnn.SoftmaxWithCriterion().forward(logits, labels)
    with pytest.raises(ValueError, match="1-based"):
        tnn.SoftmaxWithCriterion().backward(logits, labels)
    loss = tnn.SoftmaxWithCriterion(ignore_label=0).forward(logits, labels)
    assert np.isfinite(loss)


def test_class_simplex_embedding_geometry():
    """regsplex rows are unit vectors with pairwise dot -1/n
    (reference ClassSimplexCriterion.scala:43-62)."""
    k = 5
    simp = tnn.ClassSimplexCriterion(k).simplex.numpy()
    assert simp.shape == (k, k)
    gram = simp @ simp.T
    np.testing.assert_allclose(np.diag(gram), 1.0, atol=1e-5)
    np.testing.assert_allclose(gram[~np.eye(k, dtype=bool)], -1.0 / (k - 1),
                               atol=1e-5)


def test_parallel_criterion_repeat_target():
    make = combo("ParallelCriterion", [("MSECriterion", (), 0.5),
                                       ("AbsCriterion", (), 2.0)],
                 repeat_target=True)
    run_pair(make[0](), make[1](), T(X, XP), X2)
