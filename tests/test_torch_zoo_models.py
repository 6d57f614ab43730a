"""The port's image zoo (models/inception.py, vgg.py, autoencoder.py)
against the JAX package's, in f32 on the CPU.

Each Inception module (v1's, v2's and v2's grid reduction) runs at a
small plane and width beside the JAX module on carried weights
(``run_pair``: forward, input and parameter gradients at the layer
zoo's tolerance), in training mode where it holds BatchNorm (the
running statistics compared after).  ``VggForCifar10`` (32 x 32,
B 2: its classifier's BatchNormalization needs two samples) takes one
forward and one SGD step with every Dropout at p 0, the port through
its verbs, the JAX model as one jitted ``value_and_grad`` (its eager
verbs dispatch op by op); the whole ``Inception_v1(10)`` (training mode,
Dropout at p 0) and ``Inception_v2`` (eval) at their own 224 x 224, B 1,
hold their forward only: with the step each takes over 10 s on a CPU;
so do ``Vgg16`` and ``Vgg19`` (eval, 224 x 224, B 1), whose parameter
trees load from the JAX models' by key.  The
port runs ``"pallas"`` (K5's plain version on the CPU), the JAX package
its default ``"xla"`` (its own specs hold its Pallas K5 equal to
``lax.conv``, and interpret mode at 224 x 224 is too slow here).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as jnn
from bigdl_tpu.models import autoencoder as jae
from bigdl_tpu.models import inception as jinc
from bigdl_tpu.models import vgg as jvgg
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.interop import load_buffer_tree, load_param_tree
from bigdl_tpu_torch.models import autoencoder as tae
from bigdl_tpu_torch.models import inception as tinc
from bigdl_tpu_torch.models import vgg as tvgg
from bigdl_tpu_torch.models._build import Build
from bigdl_tpu_torch.ops import conv3x3
from test_torch_layer_zoo import TOL, flat_tree, run_pair

torch.set_num_threads(1)

CPU = dict(device="cpu")
TRAJ_RTOL = 2e-3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pallas(model):
    for m in model.modules():
        if isinstance(m, tnn.SpatialConvolution):
            m.set_conv_impl("pallas")
    return model


def _k5_calls(monkeypatch):
    """Shapes of the x of each K5 call, forward and dX (on the CPU both
    run K5's plain version)."""
    calls = []
    real = conv3x3._conv3x3_plain

    def spy(x, w):
        calls.append(tuple(x.shape))
        return real(x, w)

    monkeypatch.setattr(conv3x3, "_conv3x3_plain", spy)
    return calls


def _bn_fed_biases(model):
    """The keys of the conv biases that feed a BatchNormalization: in
    training mode their gradient is zero in exact arithmetic (the
    normalization subtracts the batch mean), so both packages hold only
    rounding noise there."""
    keys = []

    def walk(m, prefix):
        kids = list(m.named_children())
        for (name, child), (_, nxt) in zip(kids, kids[1:] + [(None, None)]):
            if (isinstance(child, tnn.SpatialConvolution)
                    and isinstance(nxt, tnn.BatchNormalization)):
                keys.append(f"{prefix}{name}.bias")
            walk(child, f"{prefix}{name}.")

    walk(model, "")
    return keys


def _pair_train(jm, pm, x):
    """``run_pair`` in training mode: the output, the input gradient and
    the parameter gradients at the layer zoo's tolerance, but the conv
    biases that feed a BatchNormalization, which both sides must hold at
    rounding level (1e-5 of the largest gradient)."""
    load_param_tree(pm, _np(jm.param_tree()))
    jm.training()
    pm.train()
    want = jm.forward(jnp.asarray(x))
    got = pm.forward(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL)
    go = np.random.RandomState(0).standard_normal(got.shape).astype(
        np.float32)
    jm.zero_grad_parameters()
    pm.zero_grad_parameters()
    gi_want = jm.backward(jnp.asarray(x), jnp.asarray(go))
    gi_got = pm.backward(torch.from_numpy(x), torch.from_numpy(go))
    np.testing.assert_allclose(gi_got.numpy(), np.asarray(gi_want), **TOL)
    gw = flat_tree(_np(jm.grad_tree()))
    gg = flat_tree(pm.grad_tree())
    assert sorted(gg) == sorted(gw)
    noise = _bn_fed_biases(pm)
    assert noise
    scale = max(np.abs(v).max() for v in gw.values())
    for k, w in gw.items():
        if k in noise:
            assert max(np.abs(w).max(), np.abs(gg[k]).max()) <= 1e-5 * scale
        else:
            np.testing.assert_allclose(gg[k], w, err_msg=k, **TOL)
    return got, want


# small planes and widths: (n_in, cfg) shaped like the real ones
V1_SMALL = (12, ((4,), (6, 8), (2, 4), (4,)))
V2_SMALL = (12, ((4,), (4, 6), (4, 6), ("avg", 4)))
V2_MAX_SMALL = (12, ((4,), (4, 6), (4, 6), ("max", 4)))
V2_REDUCE_SMALL = (12, ((0,), (6, 8), (4, 6), ("max", 0)))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("which,cfg,hw", [
    ("v1", V1_SMALL, 7),
    ("v2", V2_SMALL, 6),
    ("v2_max_proj", V2_MAX_SMALL, 5),
    ("v2_grid_reduction", V2_REDUCE_SMALL, 8),
], ids=lambda v: v if isinstance(v, str) else None)
def test_inception_module_matches_jax(which, cfg, hw, train):
    n_in, c = cfg
    if which == "v1":
        jm = jinc._inception_module(n_in, c, "m/")
        pm = tinc._inception_module(Build("cpu", None), n_in, c, "m/")
    else:
        jm = jinc._inception_module_v2(n_in, c, "m/")
        pm = tinc._inception_module_v2(Build("cpu", None), n_in, c, "m/")
    _pallas(pm)
    x = np.random.RandomState(21).randn(2, n_in, hw, hw).astype(np.float32)
    if train and which != "v1":
        got, want = _pair_train(jm, pm, x)
        gb = flat_tree(pm.buffer_tree())
        wb = flat_tree(_np(jm.buffer_tree()))
        assert sorted(gb) == sorted(wb)
        for k in wb:
            np.testing.assert_allclose(gb[k], wb[k], err_msg=k, **TOL)
    else:
        got, want = run_pair(jm, pm, x, train=train)
    assert tuple(got.shape) == tuple(np.asarray(want).shape)


def test_inception_modules_run_k5_on_their_3x3s(monkeypatch):
    calls = _k5_calls(monkeypatch)
    m = _pallas(tinc._inception_module_v2(Build("cpu", None),
                                          *V2_REDUCE_SMALL, "m/"))
    x = torch.randn(2, 12, 8, 8, requires_grad=True)
    m.train()
    m(x).sum().backward()
    # the grid reduction's 3x3 and double3x3b have stride 2: only
    # double3x3a runs K5, forward (x: 4 channels) and dX (its output
    # gradient: 6)
    assert calls == [(2, 8, 8, 4), (2, 8, 8, 6)]


def _step(jm, pm, x, y, training, lr=0.05):
    """One forward and one SGD step on both packages: the port's through
    the verbs, the JAX model's as one jitted ``value_and_grad`` of its
    ``apply_fn`` (its eager verbs dispatch op by op, slowly at 224 x
    224).
    Returns the port's and the JAX model's (loss, output), and the JAX
    model's parameters and buffers after the step."""
    crit = jnn.ClassNLLCriterion()

    def loss_fn(p, b, xx, yy):
        out, nb = jm.apply_fn(p, b, xx, training, None)
        return crit._loss(out, yy), (out, nb)

    (loss, (out, nb)), g = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jm.param_tree(), jm.buffer_tree(),
                                jnp.asarray(x), jnp.asarray(y))
    j_params = jax.tree_util.tree_map(lambda a, b: a - lr * b,
                                      jm.param_tree(), g)
    pcrit = tnn.ClassNLLCriterion()
    xx, yy = torch.from_numpy(x), torch.from_numpy(y)
    pm.zero_grad_parameters()
    p_out = pm.forward(xx)
    p_loss = float(pcrit.forward(p_out, yy))
    pm.backward(xx, pcrit.backward(p_out, yy))
    pm.update_parameters(lr)
    return ((p_loss, p_out.detach().numpy()),
            (float(loss), np.asarray(out)), _np(j_params), _np(nb))


def _hold_params(pm, j_params):
    want = flat_tree(j_params)
    got = flat_tree(pm.param_tree())
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TRAJ_RTOL,
                                   atol=1e-6, err_msg=k)


def _hold_outputs(p, j):
    (p_loss, p_out), (j_loss, j_out) = p, j
    assert np.abs(p_out - j_out).max() <= 1e-4 * np.abs(j_out).max()
    np.testing.assert_allclose(p_loss, j_loss, rtol=1e-5)


def _no_dropout(model):
    for m in model.modules_iter():
        if type(m).__name__ == "Dropout":
            m.set_p(0.0)
    return model


def test_inception_v1_forward_matches_jax(monkeypatch):
    """Forward only, in training mode with Dropout at p 0: with the JAX
    model's construction and jitted step the whole-model step takes over
    10 s on a CPU (the step is held card vs CPU in ``chip_smoke.py``
    phase 13 (a), the modules forward and backward above)."""
    jm = _no_dropout(jinc.Inception_v1(10))
    pm = _no_dropout(_pallas(tinc.Inception_v1(10, **CPU)))
    load_param_tree(pm, _np(jm.param_tree()))
    pm.train()
    x = np.random.RandomState(22).rand(1, 3, 224, 224).astype(np.float32)
    calls = _k5_calls(monkeypatch)
    want, _ = jax.jit(lambda p, b, xx: jm.apply_fn(p, b, xx, True, None))(
        jm.param_tree(), jm.buffer_tree(), jnp.asarray(x))
    want = np.asarray(want)
    with torch.no_grad():
        got = pm.forward(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    # the 10 3x3 stride-1 convs on K5
    assert len(calls) == 10


@pytest.mark.parametrize("frozen", [False, True],
                         ids=["training_mode", "frozen_batchnorm"])
def test_vgg_for_cifar10_forward_and_step_match_jax(monkeypatch, frozen):
    """In training mode the forward, the loss and every BatchNorm
    statistic; with BatchNorm frozen (eval mode) every parameter after
    the step.  In training mode the backward is ill conditioned at
    random init (the last stage normalizes 512 channels over two 1 x 1
    samples), so its updates are held frozen, as phase 8 of
    ``chip_smoke.py`` holds ResNet-50's."""
    jm = _no_dropout(jvgg.VggForCifar10(10))
    pm = _no_dropout(_pallas(tvgg.VggForCifar10(10, **CPU)))
    load_param_tree(pm, _np(jm.param_tree()))
    load_buffer_tree(pm, _np(jm.buffer_tree()))
    pm.train(not frozen)
    rng = np.random.RandomState(23)
    x = rng.rand(2, 3, 32, 32).astype(np.float32)
    y = np.array([3.0, 7.0], np.float32)
    calls = _k5_calls(monkeypatch)
    p, j, j_params, j_buffers = _step(jm, pm, x, y, training=not frozen)
    _hold_outputs(p, j)
    # 13 forward and 13 dX: the verbs make the input a leaf, so the first
    # conv's dX runs too (a training loop's data needs none: 12)
    assert len(calls) == 26
    if frozen:
        _hold_params(pm, j_params)
    else:
        gb, wb = flat_tree(pm.buffer_tree()), flat_tree(j_buffers)
        assert sorted(gb) == sorted(wb)
        for k in wb:
            np.testing.assert_allclose(gb[k], wb[k], err_msg=k, **TOL)


def test_autoencoder_matches_jax():
    x = np.random.RandomState(24).rand(3, 28, 28).astype(np.float32)
    run_pair(jae.Autoencoder(16), tae.Autoencoder(16, **CPU), x)


@pytest.mark.parametrize("which", ["Inception_v1", "Inception_v2",
                                   "InceptionV1NoAuxClassifier",
                                   "InceptionV2NoAuxClassifier"])
def test_inception_trees_load_from_jax(which):
    """Every parameter and BatchNorm statistic of the JAX model loads
    into the port's by key."""
    jm = getattr(jinc, which)(10)
    pm = getattr(tinc, which)(10, **CPU)
    load_param_tree(pm, _np(jm.param_tree()))
    load_buffer_tree(pm, _np(jm.buffer_tree()))
    assert sum(p.numel() for p in pm.parameters()) == sum(
        np.asarray(v).size for v in jax.tree_util.tree_leaves(
            jm.param_tree()))


@pytest.fixture(scope="module", params=[("Vgg16", 13), ("Vgg19", 16)],
                ids=["Vgg16", "Vgg19"])
def vgg_pair(request):
    """The JAX package's VGG-16/19 (1000 classes) and the port's on the
    JAX model's weights, loaded by key, and the model's count of 3x3
    convs (each on K5 under ``"pallas"``); built once for the module's
    specs (the JAX model takes seconds to build)."""
    which, n_k5 = request.param
    jm = getattr(jvgg, which)(1000)
    pm = _pallas(getattr(tvgg, which)(1000, **CPU))
    load_param_tree(pm, _np(jm.param_tree()))
    yield jm, pm, n_k5
    del jm, pm


def test_vgg_imagenet_trees_load_from_jax(vgg_pair):
    """Every parameter of the JAX model loads into the port's by key: the
    same keys, shapes and count."""
    jm, pm, _ = vgg_pair
    want = flat_tree(_np(jm.param_tree()))
    got = flat_tree(pm.param_tree())
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert sum(p.numel() for p in pm.parameters()) == sum(
        v.size for v in want.values())


def test_vgg_imagenet_forward_matches_jax(monkeypatch, vgg_pair):
    """VGG-16/19 in eval mode at their own 224 x 224, B 1, the JAX side
    jitted; every 3x3 conv runs K5 (its plain version on the CPU)."""
    jm, pm, n_k5 = vgg_pair
    jm.evaluate()
    pm.evaluate()
    x = np.random.RandomState(26).rand(1, 3, 224, 224).astype(np.float32)
    calls = _k5_calls(monkeypatch)
    want, _ = jax.jit(lambda p, b, xx: jm.apply_fn(p, b, xx, False, None))(
        jm.param_tree(), jm.buffer_tree(), jnp.asarray(x))
    want = np.asarray(want)
    with torch.no_grad():
        got = pm.forward(torch.from_numpy(x)).numpy()
    # View(512 * 7 * 7) takes a batch of one as one sample, as in JAX
    assert got.shape == want.shape == (1000,)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert len(calls) == n_k5


def test_inception_v2_forward_matches_jax():
    """Inception v2 (Inception-BN) in eval mode at its own 224 x 224."""
    jm = jinc.Inception_v2(10)
    pm = _pallas(tinc.Inception_v2(10, **CPU))
    load_param_tree(pm, _np(jm.param_tree()))
    load_buffer_tree(pm, _np(jm.buffer_tree()))
    jm.evaluate()
    pm.evaluate()
    x = np.random.RandomState(25).rand(1, 3, 224, 224).astype(np.float32)
    want, _ = jax.jit(lambda p, b, xx: jm.apply_fn(p, b, xx, False, None))(
        jm.param_tree(), jm.buffer_tree(), jnp.asarray(x))
    want = np.asarray(want)
    with torch.no_grad():
        got = pm.forward(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
