"""The port's ResNets against the JAX package on the CPU: the
space-to-depth stem, a 6-iteration ``LocalOptimizer`` trajectory of
``ResNetCifar(depth=8)`` with every 3×3 stride-1 conv on K5's route
(``"pallas"``), and ResNet-50 at full width, B 1, 224²: its parameter
and buffer trees, the forward in training and eval mode, and one
backward in eval mode (which also holds the stem max pool's routing of
tied maxima).

Inputs are made with numpy from a seed and handed to both packages;
weights cross with ``load_param_tree`` and state with
``load_buffer_tree``; the comparisons are in f32.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.dataset.dataset import array as jarray
from bigdl_tpu.models.resnet import ResNet50 as JResNet50
from bigdl_tpu.models.resnet import ResNetCifar as JResNetCifar
from bigdl_tpu.models.resnet import SpaceToDepthStem as JSpaceToDepthStem
from bigdl_tpu.optim.optimizer import LocalOptimizer as JLocalOptimizer
from bigdl_tpu.utils.rng import RNG as JRNG
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.dataset import Sample, array
from bigdl_tpu_torch.interop import load_buffer_tree, load_param_tree
from bigdl_tpu_torch.models.resnet import (ResNet50, ResNetCifar,
                                           SpaceToDepthStem)
from bigdl_tpu_torch.optim.optimizer import LocalOptimizer
from bigdl_tpu_torch.utils.rng import RNG

# The suite runs in several processes at once: one intra-op thread each
# keeps these small tensors from crowding the timing-sensitive tests.
torch.set_num_threads(1)

# the trajectory tolerance of tests/test_sharding_plan.py
TRAJ_RTOL = 2e-3
# the s2d stem's exactness tolerance (tests/test_resnet_s2d.py)
STEM_TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    """A nested dict of arrays as {dotted path: array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _set_impl(model, impl):
    for m in model.modules():
        if isinstance(m, tnn.SpatialConvolution):
            m.set_conv_impl(impl)
    return model


# ----------------------------------------------------------------------
# the space-to-depth stem (tests/test_resnet_s2d.py)
# ----------------------------------------------------------------------

def _stems(n_out, seed):
    conv7 = tnn.SpatialConvolution(3, n_out, 7, 7, 2, 2, 3, 3, device="cpu",
                                   generator=torch.Generator().manual_seed(
                                       seed))
    s2d = SpaceToDepthStem(n_out, device="cpu")
    with torch.no_grad():
        s2d.weight.copy_(SpaceToDepthStem.weight_from_conv7(conv7.weight))
        s2d.bias.copy_(conv7.bias)
    return conv7, s2d


@pytest.mark.parametrize("n_out,shape", [(64, (2, 3, 64, 64)),
                                         (8, (1, 3, 32, 32))])
def test_s2d_stem_matches_conv7_exactly(n_out, shape):
    # the second shape drives the border pixels onto the taps the remap
    # zeroes
    conv7, s2d = _stems(n_out, seed=0)
    x = torch.from_numpy(np.random.RandomState(1).randn(*shape)
                         .astype(np.float32))
    ref, got = conv7(x), s2d(x)
    assert got.shape == ref.shape == (shape[0], n_out, shape[2] // 2,
                                      shape[3] // 2)
    np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(),
                               **STEM_TOL)


def test_s2d_remap_and_mask_match_jax():
    w7 = np.random.RandomState(2).randn(4, 3, 7, 7).astype(np.float32)
    np.testing.assert_array_equal(
        SpaceToDepthStem.weight_from_conv7(w7).numpy(),
        np.asarray(JSpaceToDepthStem.weight_from_conv7(w7)))
    np.testing.assert_array_equal(
        SpaceToDepthStem._valid_tap_mask().numpy(),
        np.asarray(JSpaceToDepthStem._valid_tap_mask()))


def test_s2d_masked_taps_frozen_under_training():
    s2d = SpaceToDepthStem(8, device="cpu")
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 3, 16, 16)
                         .astype(np.float32))
    mask = SpaceToDepthStem._valid_tap_mask()
    (g,) = torch.autograd.grad((s2d(x) ** 2).sum(), s2d.weight)
    assert bool((g * (1 - mask) == 0).all())
    # dirty out-of-window taps (a foreign checkpoint) change nothing
    y0 = s2d(x)
    dirty = dict(s2d.param_tree(), weight=s2d.weight + 7.0 * (1 - mask))
    np.testing.assert_allclose(s2d.apply_fn(dirty, x).detach().numpy(),
                               y0.detach().numpy(), rtol=1e-6)


def test_weight_from_conv7_keeps_dtype_and_stem_is_validated():
    ws = SpaceToDepthStem.weight_from_conv7(
        torch.ones(4, 3, 7, 7, dtype=torch.bfloat16))
    assert ws.dtype == torch.bfloat16 and ws.shape == (4, 12, 4, 4)
    with pytest.raises(ValueError):
        ResNet50(10, stem="S2D", device="cpu")
    with pytest.raises(ValueError):
        SpaceToDepthStem(4, device="cpu")(torch.zeros(1, 3, 7, 8))


# ----------------------------------------------------------------------
# ResNet-CIFAR: the LocalOptimizer trajectory on K5's route
# ----------------------------------------------------------------------

B_CIFAR, N_CIFAR, ITERS = 4, 8, 6


def _recording(trigger, losses):
    def check(state):
        if "loss" in state:
            losses.append(state["loss"])
        return trigger(state)

    return check


def _train(opt, optim_pkg, rng):
    losses = []
    opt.set_optim_method(optim_pkg.SGD(0.05, momentum=0.9))
    opt.set_end_when(optim_pkg.Trigger(_recording(
        optim_pkg.max_iteration(ITERS), losses)))
    rng().set_seed(1)
    opt.optimize()
    return losses


def test_resnet_cifar_trajectory_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(N_CIFAR, 3, 32, 32).astype(np.float32)
    y = rng.randint(1, 11, size=N_CIFAR).astype(np.float32)
    jmodel = JResNetCifar(8, 10, "A")
    for m in jmodel.modules_iter():
        if hasattr(m, "set_conv_impl"):
            m.set_conv_impl("pallas")
    tmodel = _set_impl(ResNetCifar(8, 10, "A", device="cpu"), "pallas")
    load_param_tree(tmodel, _np(jmodel.param_tree()))
    load_buffer_tree(tmodel, _np(jmodel.buffer_tree()))
    n_k5 = sum(isinstance(m, tnn.SpatialConvolution)
               and (m.kernel_w, m.stride_w, m.pad_w) == (3, 1, 1)
               for m in tmodel.modules())
    assert n_k5 == 5   # the stem conv and both convs of stage 1's block,
    #                    the second conv of stages 2 and 3
    jopt = JLocalOptimizer(jmodel, jarray([JSample(a, b) for a, b in
                                           zip(x, y)]),
                           jnn.ClassNLLCriterion(), batch_size=B_CIFAR)
    topt = LocalOptimizer(tmodel, array([Sample(a, b) for a, b in zip(x, y)]),
                          tnn.ClassNLLCriterion(), batch_size=B_CIFAR)
    jlosses = _train(jopt, joptim, JRNG)
    tlosses = _train(topt, toptim, RNG)
    assert len(tlosses) == len(jlosses) == ITERS
    assert topt.skipped_steps == jopt.skipped_steps == 0
    np.testing.assert_allclose(tlosses, jlosses, rtol=TRAJ_RTOL)
    for kind in ("param", "buffer"):
        want = _flat(_np(getattr(jmodel, f"{kind}_tree")()))
        got = _flat(jax.tree_util.tree_map(
            lambda t: t.detach().numpy(), getattr(tmodel, f"{kind}_tree")()))
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            np.testing.assert_allclose(got[name], w, rtol=TRAJ_RTOL,
                                       atol=1e-6, err_msg=name)


# ----------------------------------------------------------------------
# ResNet-50 at full width, B 1
# ----------------------------------------------------------------------

def test_resnet50_trees_forward_and_backward_match_jax():
    """The trees, the forward in training mode (batch statistics) and in
    eval mode (running statistics), and the gradient of every parameter
    under a random output gradient.  The port runs every 3×3 stride-1
    conv on K5's route (its plain version here), the JAX model its
    default XLA conv.

    The backward is compared in eval mode.  In training mode at B 1 it
    is ill-conditioned: the global average pool hands each late
    BatchNorm an output gradient that is nearly constant over the
    positions it normalizes, and BatchNorm's backward subtracts that
    gradient's mean, so both packages' summation-order noise comes out
    at 1-2 % of the BatchNorm gradients (and the conv biases before a
    BatchNorm, zero in exact arithmetic, are noise alone).  In eval
    mode every gradient agrees to ~1e-5, the stem conv's included: the
    stem max pool routes tied maxima to the first element of the window
    on both sides."""
    jmodel = JResNet50(10)
    tmodel = _set_impl(ResNet50(10, device="cpu"), "pallas")
    jp, jb = _np(jmodel.param_tree()), _np(jmodel.buffer_tree())
    assert {k: tuple(v.shape) for k, v in tmodel.named_parameters()} == {
        k: v.shape for k, v in _flat(jp).items()}
    assert {k: tuple(v.shape) for k, v in tmodel.named_buffers()} == {
        k: v.shape for k, v in _flat(jb).items()}
    load_param_tree(tmodel, jp)
    load_buffer_tree(tmodel, jb)
    rng = np.random.RandomState(2)
    x = rng.rand(1, 3, 224, 224).astype(np.float32)
    gy = rng.randn(10).astype(np.float32)

    y_train, _ = jmodel.apply_fn(jmodel.param_tree(), jmodel.buffer_tree(),
                                 jnp.asarray(x), True, None)
    tmodel.train()
    with torch.no_grad():
        yt = tmodel(torch.from_numpy(x))
    assert yt.shape == y_train.shape == (10,)   # View(2048) drops a batch of 1
    np.testing.assert_allclose(yt.numpy(), np.asarray(y_train), rtol=1e-4,
                               atol=1e-5)

    def f(p):
        return jmodel.apply_fn(p, jmodel.buffer_tree(), jnp.asarray(x), False,
                               None)[0]

    y_eval, vjp = jax.vjp(f, jmodel.param_tree())
    (grads,) = vjp(jnp.asarray(gy))
    tmodel.evaluate()
    load_buffer_tree(tmodel, jb)
    names, leaves = zip(*tmodel.named_parameters())
    yt = tmodel(torch.from_numpy(x))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y_eval),
                               rtol=1e-4, atol=1e-5)
    got = dict(zip(names, torch.autograd.grad(yt, leaves,
                                              torch.from_numpy(gy))))
    for name, g in _flat(_np(grads)).items():
        err = np.linalg.norm(got[name].numpy() - g) / np.linalg.norm(g)
        assert err <= 1e-4, (name, err)
