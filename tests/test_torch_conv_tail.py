"""The port's conv and pooling tail against the JAX package's, in f32 on
the CPU: ``SpatialShareConvolution``, ``SpatialDilatedConvolution``,
``SpatialFullConvolution`` (the transposed conv, with ``adj`` and
groups), ``SpatialConvolutionMap``, ``TemporalConvolution``,
``VolumetricConvolution``, ``VolumetricMaxPooling`` and ``RoiPooling``.

Each case carries the JAX layer's weights across
(``load_param_tree``), runs both layers' verbs on the same seeded numpy
input — forward, then backward of a seeded output gradient — and holds
the output, the input gradient and every parameter gradient at the
layer zoo's tolerance (``run_pair``).
"""
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.nn import conv as tconv
from bigdl_tpu_torch.utils.table import Table as PTable
from test_torch_layer_zoo import T, run_pair

torch.set_num_threads(1)

CPU = dict(device="cpu")
R = np.random.RandomState(11)
X4 = R.randn(2, 4, 7, 6).astype(np.float32)
X3 = R.randn(4, 5, 5).astype(np.float32)
X5 = R.randn(2, 2, 5, 6, 7).astype(np.float32)
SEQ = R.randn(2, 9, 4).astype(np.float32)
CONN = [[1, 1], [2, 1], [2, 2], [3, 2], [4, 3], [1, 3]]

CASES = [
    ("SpatialShareConvolution", (4, 5, 3, 3, 1, 1, 1, 1), {}, X4),
    ("SpatialShareConvolution_s2", (4, 6, 3, 2, 2, 1, 0, 1), {}, X4),
    ("SpatialDilatedConvolution", (4, 5, 3, 3, 1, 1, 2, 2, 2, 2), {}, X4),
    ("SpatialDilatedConvolution_s2", (4, 3, 3, 2, 2, 1, 1, 0, 1, 3), {}, X4),
    ("SpatialFullConvolution", (4, 6, 3, 3, 2, 2, 1, 1, 1, 1), {}, X4),
    ("SpatialFullConvolution_groups", (4, 6, 3, 3, 2, 2, 1, 1, 1, 0, 2),
     {}, X4),
    ("SpatialFullConvolution_k4", (4, 3, 4, 4, 2, 2, 1, 1), {}, X4),
    ("SpatialFullConvolution_adj_past_pad", (4, 3, 3, 3, 2, 2, 0, 0, 1, 1),
     {}, X4),
    ("SpatialFullConvolution_nobias_nobatch", (4, 2, 2, 3, 1, 1),
     {"no_bias": True}, X3),
    ("SpatialConvolutionMap", (CONN, 3, 3, 1, 1, 1, 1), {}, X4),
    ("SpatialConvolutionMap_s2_nobatch", (CONN, 2, 3, 2, 1), {}, X3),
    ("TemporalConvolution", (4, 5, 3, 2), {}, SEQ),
    ("TemporalConvolution_nobatch", (4, 3, 2), {}, SEQ[0]),
    ("VolumetricConvolution", (2, 3, 2, 3, 3, 1, 2, 1, 1, 1, 0), {}, X5),
    ("VolumetricConvolution_nobias", (2, 4, 3, 2, 2, 2, 1, 1, 0, 1, 1),
     {"with_bias": False}, X5[0]),
    ("VolumetricMaxPooling", (2, 2, 2), {}, X5),
    ("VolumetricMaxPooling_pad", (3, 3, 2, 2, 2, 1, 1, 1, 0), {}, X5),
]


def _cls(name):
    return name.split("_")[0]


@pytest.mark.parametrize("name,args,kw,x", CASES, ids=[c[0] for c in CASES])
def test_conv_pool_tail_matches_jax(name, args, kw, x):
    jm = getattr(jnn, _cls(name))(*args, **kw)
    pm = getattr(tnn, _cls(name))(*args, **kw, **CPU)
    got, want = run_pair(jm, pm, x)
    assert tuple(got.shape) == tuple(np.asarray(want).shape)


def test_full_convolution_matches_torch_transposed_conv():
    """Where ``adj`` is below the stride, the cut full output is
    ``F.conv_transpose2d`` with ``output_padding``."""
    m = tnn.SpatialFullConvolution(4, 6, 3, 3, 2, 2, 1, 1, 1, 1, n_group=2,
                                   **CPU)
    x = torch.from_numpy(X4)
    want = torch.nn.functional.conv_transpose2d(
        x, m.weight, m.bias, 2, 1, (1, 1), groups=2)
    torch.testing.assert_close(m(x), want, rtol=1e-5, atol=1e-6)


def test_share_convolution_takes_k5_under_pallas(monkeypatch):
    """Under ``"pallas"`` the 3x3 stride-1 pad-1 share conv runs K5's
    entry point, as ``SpatialConvolution`` does; the JAX layer's
    ``"xla"`` result is what it must give."""
    calls = []
    real = tconv.conv3x3_s1_same

    def spy(x, w):
        calls.append(tuple(x.shape))
        return real(x, w)

    monkeypatch.setattr(tconv, "conv3x3_s1_same", spy)
    jm = jnn.SpatialShareConvolution(4, 5, 3, 3, 1, 1, 1, 1)
    pm = tnn.SpatialShareConvolution(4, 5, 3, 3, 1, 1, 1, 1, **CPU)
    pm.set_conv_impl("pallas")
    run_pair(jm, pm, X4)
    # the forward and the backward's replay
    assert calls and all(c == (2, 7, 6, 4) for c in calls)
    # the dilated conv never does
    calls.clear()
    dm = tnn.SpatialDilatedConvolution(4, 5, 3, 3, 1, 1, 1, 1, 1, 1, **CPU)
    dm.set_conv_impl("pallas")
    dm(torch.from_numpy(X4))
    assert not calls


def _rois():
    # 1-based batch index, corners in input pixels: an ordinary box, one
    # past the image's edge, one with half-pixel corners (round half to
    # even), a one-pixel box whose bins repeat a pixel, one wholly past
    # the image (empty bins read 0)
    return np.array([[1, 0, 0, 7, 5],
                     [2, 3, 2, 14, 13],
                     [1, 2.5, 1.5, 6.5, 4.5],
                     [2, 4, 4, 4, 4],
                     [1, 30, 30, 40, 40]], np.float32)


@pytest.mark.parametrize("pooled,scale", [((3, 2), 1.0), ((2, 4), 0.5),
                                          ((4, 4), 1.0)])
def test_roi_pooling_matches_jax(pooled, scale):
    data = np.random.RandomState(12).randn(2, 3, 8, 10).astype(np.float32)
    jm = jnn.RoiPooling(pooled[0], pooled[1], scale)
    pm = tnn.RoiPooling(pooled[0], pooled[1], scale, **CPU)
    got, want = run_pair(jm, pm, T(data, _rois()))
    assert tuple(got.shape) == (5, 3, pooled[1], pooled[0])
    assert not got[-1].any()


def test_roi_pooling_matches_a_loop():
    """Each bin's max by explicit loops over the reference's formulas."""
    data = np.random.RandomState(13).randn(2, 3, 8, 10).astype(np.float32)
    rois = _rois()
    pw, ph, scale = 3, 2, 1.0
    got = tnn.RoiPooling(pw, ph, scale, **CPU).forward(
        PTable(torch.from_numpy(data), torch.from_numpy(rois)))
    H, W = data.shape[2:]
    for r, roi in enumerate(rois):
        b = int(roi[0]) - 1
        x1, y1, x2, y2 = (int(np.round(np.float32(v * scale)))
                          for v in roi[1:])
        rh, rw = max(y2 - y1 + 1, 1), max(x2 - x1 + 1, 1)
        bh, bw = np.float32(rh) / np.float32(ph), np.float32(rw) / np.float32(pw)
        for py in range(ph):
            for px in range(pw):
                hs = min(max(int(np.floor(py * bh)) + y1, 0), H)
                he = min(max(int(np.ceil((py + 1) * bh)) + y1, 0), H)
                ws = min(max(int(np.floor(px * bw)) + x1, 0), W)
                we = min(max(int(np.ceil((px + 1) * bw)) + x1, 0), W)
                want = (np.zeros(3, np.float32) if he <= hs or we <= ws
                        else data[b, :, hs:he, ws:we].max(axis=(1, 2)))
                np.testing.assert_array_equal(got[r, :, py, px].numpy(),
                                              want)
