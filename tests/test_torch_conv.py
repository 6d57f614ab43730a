"""The port's conv slice against the JAX package on the CPU, at tiny
shapes: kernel K5's plain version and the CPU route of
``conv3x3_s1_same`` against the Pallas kernel in interpret mode
(forward, dX and dW), the k² GEMM conv, ``SpatialConvolution`` under
every impl, BatchNorm in training and eval mode with its running
statistics, both poolings, the containers' parameter trees, the guard
restoring BatchNorm's state on a skipped step, and a 6-iteration LeNet-5
``LocalOptimizer`` trajectory.

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
from bigdl_tpu.models.lenet import LeNet5 as JLeNet5
from bigdl_tpu.ops.conv3x3_pallas import conv3x3_s1_same as jconv3x3
from bigdl_tpu.ops.conv_gemm import conv2d_gemm_nchw as jgemm_nchw
from bigdl_tpu.ops.conv_gemm import conv2d_gemm_nhwc as jgemm_nhwc
from bigdl_tpu.optim.optimizer import LocalOptimizer as JLocalOptimizer
from bigdl_tpu.utils.rng import RNG as JRNG
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.dataset import Sample, array
from bigdl_tpu_torch.interop import load_buffer_tree, load_param_tree
from bigdl_tpu_torch.interop.jax_params import param_tree_numpy
from bigdl_tpu_torch.models.lenet import LeNet5
from bigdl_tpu_torch.ops import conv3x3
from bigdl_tpu_torch.ops.conv_gemm import conv2d_gemm_nchw, conv2d_gemm_nhwc
from bigdl_tpu_torch.optim.optimizer import LocalOptimizer
from bigdl_tpu_torch.utils.rng import RNG

# The suite runs in several processes at once: one intra-op thread each
# keeps these small tensors from crowding the timing-sensitive tests.
torch.set_num_threads(1)

# K5's forward tolerance and its gradients' (tests/test_conv3x3_pallas.py)
FWD_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-3, atol=1e-3)
# single layers in f32 (tests/test_conv_gemm.py)
TOL = dict(rtol=1e-5, atol=1e-5)
# the trajectory tolerance of tests/test_sharding_plan.py
TRAJ_RTOL = 2e-3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    """A nested dict of arrays as {dotted path: array}: the port's
    ``named_parameters``/``state_dict`` names."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _pair(seed, x_shape, w_shape, w_scale=0.1):
    rng = np.random.RandomState(seed)
    return (rng.randn(*x_shape).astype(np.float32),
            (rng.randn(*w_shape) * w_scale).astype(np.float32))


# ----------------------------------------------------------------------
# K5: plain version and the CPU route vs the Pallas kernel (interpret)
# ----------------------------------------------------------------------

K5_SHAPES = [(1, 8, 8, 8, 8), (2, 12, 10, 8, 16), (2, 7, 5, 3, 10)]


@pytest.mark.parametrize("B,H,W,C,O", K5_SHAPES)
def test_conv3x3_forward_matches_pallas_interpret(B, H, W, C, O):
    x, w = _pair(5, (B, H, W, C), (3, 3, C, O))
    want = np.asarray(jconv3x3(jnp.asarray(x), jnp.asarray(w),
                               interpret=True))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    for got in (conv3x3._conv3x3_plain(xt, wt),
                conv3x3.conv3x3_s1_same(xt, wt)):
        assert got.shape == (B, H, W, O)
        np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


@pytest.mark.parametrize("B,H,W,C,O", [K5_SHAPES[0], K5_SHAPES[2]])
def test_conv3x3_grads_match_pallas_interpret(B, H, W, C, O):
    x, w = _pair(6, (B, H, W, C), (3, 3, C, O))

    def loss(a, b):
        return jnp.sum(jconv3x3(a, b, interpret=True) ** 2)

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    before = conv3x3.LAUNCHES.count
    got = torch.autograd.grad(
        (conv3x3.conv3x3_s1_same(xt, wt) ** 2).sum(), (xt, wt))
    assert conv3x3.LAUNCHES.count == before   # CPU tensors: no kernel
    for g, ref in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), **GRAD_TOL)


def _dw_per_tap(x, g):
    """dW as nine products of shifted slices of the padded x, one copy
    each (the formula ``_conv3x3_dw`` replaced), in f32."""
    B, H, W, C = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    gf = g.reshape(B * H * W, -1)
    return torch.stack([xp[:, dy:dy + H, dx:dx + W, :].reshape(-1, C).t()
                        @ gf for dy in range(3) for dx in range(3)]
                       ).reshape(3, 3, C, gf.shape[1])


@pytest.mark.parametrize("B,H,W,C,O,big", [
    (3, 5, 4, 6, 7, 1),      # image 1 of 3 at 1e6: no image leaks
    (2, 1, 1, 5, 3, None),   # H = W = 1: every tap but the centre is pad
    (2, 7, 5, 3, 10, None)])
def test_conv3x3_dw_windows_match_the_per_tap_formula(B, H, W, C, O, big):
    """Each tap of ``_conv3x3_dw`` is one window of the flattened padded
    x; it must equal the per-tap slices.  The scale term of atol covers
    sums that cancel (relative error then means nothing); a row of
    another image meeting a live row of g would miss by 1e6."""
    x, g = _pair(8, (B, H, W, C), (B, H, W, O), w_scale=1.0)
    if big is not None:
        x[big] = 1e6
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    want = _dw_per_tap(xt, gt)
    got = conv3x3._conv3x3_dw(xt, gt)
    assert got.shape == (3, 3, C, O)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6 * want.abs().max().item())


@pytest.mark.parametrize("C", [3, 12])
def test_conv3x3_channel_pad_matches_pallas_interpret(C):
    """The bf16 kernel's channel pad (C to a multiple of 8, at least 16),
    applied on the CPU to x and the (tap, out, in) weights, leaves the
    conv unchanged: against the JAX kernel in interpret mode, O 10."""
    B, H, W, O = 2, 7, 5, 10
    x, w = _pair(9, (B, H, W, C), (3, 3, C, O))
    want = np.asarray(jconv3x3(jnp.asarray(x), jnp.asarray(w),
                               interpret=True))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    xp, wkp = conv3x3._pad_channels(xt, wt.permute(0, 1, 3, 2))
    assert xp.shape == (B, H, W, 16) and wkp.shape == (3, 3, O, 16)
    assert not xp[..., C:].any() and not wkp[..., C:].any()
    got = conv3x3._conv3x3_plain(xp, wkp.permute(0, 1, 3, 2))
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


def test_conv3x3_rejects_a_mismatched_weight():
    with pytest.raises(ValueError):
        conv3x3.conv3x3_s1_same(torch.zeros(1, 4, 4, 3),
                                torch.zeros(3, 3, 4, 2))
    with pytest.raises(ValueError):
        conv3x3.conv3x3_s1_same(torch.zeros(1, 4, 4, 3),
                                torch.zeros(5, 5, 3, 2))


# ----------------------------------------------------------------------
# the k² GEMM conv
# ----------------------------------------------------------------------

@pytest.mark.parametrize("k,s,pad", [
    (1, 1, 0), (1, 2, 0), (3, 1, 1), (3, 2, 1), (7, 2, 3), (5, 1, 2),
    (3, 2, "SAME")])
def test_gemm_conv_matches_jax(k, s, pad):
    x, w = _pair(3, (2, 15, 15, 5), (k, k, 5, 7))
    padding = "SAME" if pad == "SAME" else (pad, pad)
    want = jgemm_nhwc(jnp.asarray(x), jnp.asarray(w), (s, s), padding)
    got = conv2d_gemm_nhwc(torch.from_numpy(x), torch.from_numpy(w), (s, s),
                           padding)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    xc = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    wc = np.ascontiguousarray(w.transpose(3, 2, 0, 1))
    want = jgemm_nchw(jnp.asarray(xc), jnp.asarray(wc), (s, s), padding)
    got = conv2d_gemm_nchw(torch.from_numpy(xc), torch.from_numpy(wc),
                           (s, s), padding)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ----------------------------------------------------------------------
# layers: forward and backward against the JAX layer
# ----------------------------------------------------------------------

def _layer_pair(jm, tm, x, training=True, seed=0):
    """Forward output and the gradients of input and parameters under a
    random output gradient, both layers, in ``training`` mode.  The JAX
    side's buffers are left alone (``apply_fn``); the port's update in
    place, as its forward does."""
    params = jm.param_tree()
    load_param_tree(tm, _np(params))
    load_buffer_tree(tm, _np(jm.buffer_tree()))
    tm.train(training)

    def f(p, a):
        return jm.apply_fn(p, jm.buffer_tree(), a, training, None)[0]

    y, vjp = jax.vjp(f, params, jnp.asarray(x))
    gy = np.random.RandomState(seed).randn(*y.shape).astype(np.float32)
    gp, gx = vjp(jnp.asarray(gy))
    xt = torch.from_numpy(x).requires_grad_()
    names, leaves = zip(*tm.named_parameters()) if len(
        list(tm.parameters())) else ((), ())
    yt = tm(xt)
    got = torch.autograd.grad(yt, [xt, *leaves], torch.from_numpy(gy))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y), **TOL)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(gx),
                               rtol=1e-4, atol=1e-5)
    want_p = _flat(_np(gp))
    assert sorted(want_p) == sorted(names)
    for name, g in zip(names, got[1:]):
        np.testing.assert_allclose(g.numpy(), want_p[name], rtol=1e-4,
                                   atol=1e-5, err_msg=name)


CONV_ARGS = [(4, 8, 3, 3, 1, 1, 1, 1), (4, 8, 5, 5, 2, 2, 2, 2),
             (3, 8, 7, 7, 2, 2, -1, -1), (4, 6, 1, 1, 1, 1, 0, 0)]


@pytest.mark.parametrize("impl", ["xla", "xla_nhwc", "gemm", "pallas"])
@pytest.mark.parametrize("args", CONV_ARGS,
                         ids=lambda a: "x".join(map(str, a)))
def test_spatial_convolution_matches_jax(impl, args):
    jm = jnn.SpatialConvolution(*args)
    tm = tnn.SpatialConvolution(*args, device="cpu").set_conv_impl(impl)
    x = np.random.RandomState(1).randn(2, args[0], 10, 10).astype(np.float32)
    before = conv3x3.LAUNCHES.count
    _layer_pair(jm, tm, x)
    assert conv3x3.LAUNCHES.count == before


def test_pallas_impl_keeps_the_native_conv_off_its_shape(monkeypatch):
    """Under "pallas" only a 3×3, stride-1, pad-1 ungrouped conv reaches
    ``conv3x3_s1_same``; every other shape keeps ``F.conv2d``."""
    from bigdl_tpu_torch.nn import conv as tconv

    calls = []
    real = tconv.conv3x3_s1_same
    monkeypatch.setattr(tconv, "conv3x3_s1_same",
                        lambda x, w: calls.append(x.shape) or real(x, w))
    x = torch.randn(2, 4, 10, 10)
    for args, want in (((4, 8, 3, 3, 1, 1, 1, 1), 1),
                       ((4, 8, 3, 3, 2, 2, 1, 1), 0),
                       ((4, 8, 5, 5, 1, 1, 2, 2), 0),
                       ((4, 8, 3, 3, 1, 1, 1, 1, 2), 0)):
        calls.clear()
        m = tnn.SpatialConvolution(*args, device="cpu")
        ref = m(x)
        m.set_conv_impl("pallas")
        torch.testing.assert_close(m(x), ref, rtol=1e-5, atol=1e-5)
        assert len(calls) == want, args
    with pytest.raises(ValueError):
        m.set_conv_impl("cudnn")


def test_conv_emits_the_weight_dtype():
    m = tnn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1, device="cpu")
    m.set_conv_impl("pallas")
    p = {k: v.to(torch.bfloat16) for k, v in m.param_tree().items()}
    y = m.apply_fn(p, torch.randn(2, 3, 6, 6))
    assert y.dtype == torch.bfloat16 and y.shape == (2, 4, 6, 6)


def test_batchnorm_train_eval_and_running_stats():
    x = np.random.RandomState(2).randn(6, 5).astype(np.float32) * 3 + 1
    x4 = np.random.RandomState(3).randn(2, 3, 5, 4).astype(np.float32)
    for jm, tm, inp in ((jnn.BatchNormalization(5),
                         tnn.BatchNormalization(5, device="cpu"), x),
                        (jnn.SpatialBatchNormalization(3),
                         tnn.SpatialBatchNormalization(3, device="cpu"), x4)):
        _layer_pair(jm, tm, inp)
        load_buffer_tree(tm, _np(jm.buffer_tree()))
        # two forwards in training mode move the running statistics
        for scale in (1.0, 2.0):
            jm.forward(jnp.asarray(inp * scale))
            tm(torch.from_numpy(inp * scale))
        for key in ("running_mean", "running_var"):
            assert tm.buffer_tree()[key].dtype == torch.float32
            np.testing.assert_allclose(tm.buffer_tree()[key].numpy(),
                                       np.asarray(jm.buffer_tree()[key]),
                                       rtol=1e-5, atol=1e-6)
        # eval mode reads them (forward and backward)
        jm.evaluate()
        _layer_pair(jm, tm, inp, training=False)


def test_batchnorm_stats_stay_f32_under_bf16():
    tm = tnn.SpatialBatchNormalization(3, device="cpu")
    x = torch.randn(4, 3, 5, 5).to(torch.bfloat16)
    p = {k: v.to(torch.bfloat16) for k, v in tm.param_tree().items()}
    y = tm.apply_fn(p, x)
    assert y.dtype == torch.bfloat16
    assert tm.running_mean.dtype == tm.running_var.dtype == torch.float32
    assert not torch.equal(tm.running_mean, torch.zeros(3))


POOLS = [
    ("max", (3, 3, 2, 2), {}), ("max", (3, 3, 2, 2), {"ceil": True}),
    ("max", (3, 3, 2, 2, 1, 1), {}), ("max", (2, 2, 2, 2, 1, 1),
                                      {"ceil": True}),
    ("max", (3, 3, 2, 2, -1, -1), {}),
    ("avg", (2, 2, 2, 2), {}), ("avg", (3, 3, 2, 2, 1, 1), {"ceil": True}),
    ("avg", (3, 3, 2, 2, 1, 1), {"count_include_pad": False}),
    ("avg", (3, 3, 2, 2, -1, -1), {}), ("avg", (1, 1, 2, 2), {}),
    ("avg", (3, 3, 1, 1), {"divide": False}),
]


@pytest.mark.parametrize("kind,args,kw", POOLS, ids=lambda v: str(v))
def test_pooling_matches_jax(kind, args, kw):
    kw = dict(kw)
    x = np.random.RandomState(4).randn(2, 3, 9, 8).astype(np.float32)
    if kind == "max":
        jm, tm = (jnn.SpatialMaxPooling(*args),
                  tnn.SpatialMaxPooling(*args, device="cpu"))
        if kw.get("ceil"):
            jm.ceil()
            tm.ceil()
    else:
        ceil = kw.pop("ceil", False)
        jm = jnn.SpatialAveragePooling(*args, ceil_mode=ceil, **kw)
        tm = tnn.SpatialAveragePooling(*args, ceil_mode=ceil, **kw,
                                       device="cpu")
    _layer_pair(jm, tm, x)


def test_maxpool_ties_route_like_jax():
    """Tied maxima (zeros and small integers after a ReLU) send the
    gradient to the same element on both sides: the first in the
    window."""
    x = np.maximum(np.round(np.random.RandomState(0).randn(2, 3, 9, 9)),
                   0).astype(np.float32)
    for args in ((3, 3, 2, 2, 1, 1), (2, 2, 2, 2), (3, 3, 1, 1)):
        _layer_pair(jnn.SpatialMaxPooling(*args),
                    tnn.SpatialMaxPooling(*args, device="cpu"), x)


# ----------------------------------------------------------------------
# containers
# ----------------------------------------------------------------------

def _block(pkg, **kw):
    """A residual block with every container of the slice."""
    return pkg.Sequential(
        pkg.ConcatTable(
            pkg.Sequential(pkg.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1,
                                                  **kw),
                           pkg.SpatialBatchNormalization(4, **kw),
                           pkg.ReLU(True, **kw), **kw),
            pkg.Sequential(pkg.Concat(2, pkg.Identity(**kw),
                                      pkg.SpatialConvolution(3, 1, 1, 1,
                                                             **kw), **kw),
                           pkg.MulConstant(0.5, **kw), **kw), **kw),
        pkg.CAddTable(True, **kw), **kw)


def _shapes(tree):
    return {k: tuple(np.shape(v)) for k, v in _flat(tree).items()}


def test_container_trees_and_outputs_match_jax():
    jm, tm = _block(jnn), _block(tnn, device="cpu")
    assert _shapes(tm.param_tree()) == _shapes(_np(jm.param_tree()))
    assert _shapes(tm.buffer_tree()) == _shapes(_np(jm.buffer_tree()))
    assert set(tm.state_dict()) == set(_flat(_np(jm.param_tree()))) | set(
        _flat(_np(jm.buffer_tree())))
    x = np.random.RandomState(5).randn(2, 3, 6, 6).astype(np.float32)
    _layer_pair(jm, tm, x)
    with pytest.raises(KeyError):
        load_buffer_tree(tm, {"0": {}})


def test_reshape_and_view_match_jax():
    for jm, tm, shape in (
            (jnn.Reshape([1, 28, 28]), tnn.Reshape([1, 28, 28], device="cpu"),
             (3, 784)),
            (jnn.Reshape([1, 28, 28]), tnn.Reshape([1, 28, 28], device="cpu"),
             (1, 28, 28)),
            (jnn.View(64), tnn.View(64, device="cpu"), (4, 64, 1, 1)),
            (jnn.View(64), tnn.View(64, device="cpu"), (1, 64, 1, 1)),
            (jnn.View(-1, 8), tnn.View(-1, 8, device="cpu"), (2, 4, 4))):
        x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
        want = np.asarray(jm.forward(jnp.asarray(x)))
        got = tm(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------------
# the training loop: BatchNorm state under the guard, LeNet-5
# ----------------------------------------------------------------------

def _bn_problem(nan: bool):
    rng = np.random.RandomState(11)
    xs = rng.randn(4, 3, 6, 6).astype(np.float32)
    if nan:
        xs[1, 0, 2, 2] = np.nan
    ys = rng.randint(1, 5, size=4).astype(np.int32)
    return array([Sample(x, y) for x, y in zip(xs, ys)])


@pytest.mark.parametrize("nan", [True, False])
def test_guard_restores_batchnorm_state_on_a_skipped_step(nan):
    model = tnn.Sequential(
        tnn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1, device="cpu"),
        tnn.SpatialBatchNormalization(4, device="cpu"),
        tnn.ReLU(device="cpu"), tnn.View(4 * 36, device="cpu"),
        tnn.Linear(4 * 36, 4, device="cpu"), tnn.LogSoftMax(device="cpu"),
        device="cpu")
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt = LocalOptimizer(model, _bn_problem(nan), tnn.ClassNLLCriterion(),
                         batch_size=4)
    opt.set_optim_method(toptim.SGD(0.1)).set_end_when(
        toptim.max_iteration(1))
    opt.optimize()
    after = model.state_dict()
    for key in ("1.running_mean", "1.running_var", "0.weight"):
        assert torch.equal(before[key], after[key]) == nan, key
    assert opt.skipped_steps == int(nan)


LENET_B, LENET_N, ITERS = 8, 16, 6


def _recording(trigger, losses):
    def check(state):
        if "loss" in state:
            losses.append(state["loss"])
        return trigger(state)

    return check


def _train(opt, optim_pkg, rng):
    losses = []
    opt.set_optim_method(optim_pkg.SGD(0.05))
    opt.set_end_when(optim_pkg.Trigger(_recording(
        optim_pkg.max_iteration(ITERS), losses)))
    rng().set_seed(1)
    opt.optimize()
    return losses


def test_lenet5_trajectory_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.rand(LENET_N, 28, 28).astype(np.float32)
    y = rng.randint(1, 11, size=LENET_N).astype(np.float32)
    jmodel = JLeNet5(10)
    tmodel = LeNet5(10, device="cpu")
    load_param_tree(tmodel, _np(jmodel.param_tree()))
    assert tmodel[1].get_name() == "conv1_5x5"
    jopt = JLocalOptimizer(jmodel, jarray([JSample(a, b) for a, b in
                                           zip(x, y)]),
                           jnn.ClassNLLCriterion(), batch_size=LENET_B)
    topt = LocalOptimizer(tmodel, array([Sample(a, b) for a, b in zip(x, y)]),
                          tnn.ClassNLLCriterion(), batch_size=LENET_B)
    jlosses = _train(jopt, joptim, JRNG)
    tlosses = _train(topt, toptim, RNG)
    assert len(tlosses) == len(jlosses) == ITERS
    assert topt.optim_method.state["epoch"] == jopt.optim_method.state["epoch"]
    np.testing.assert_allclose(tlosses, jlosses, rtol=TRAJ_RTOL)
    want = jax.tree_util.tree_leaves(_np(jmodel.param_tree()))
    got = jax.tree_util.tree_leaves(param_tree_numpy(tmodel))
    assert len(want) == len(got)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=TRAJ_RTOL, atol=1e-6)
