"""Inception v1 / v2 for ImageNet (counterpart of
``bigdl_tpu/models/inception.py``; reference
models/inception/Inception_v1.scala, Inception_v2.scala): the perf
harness's large-batch workloads (``bigdl_tpu/models/perf.py``).

Under the ``"pallas"`` conv impl every 3×3 stride-1 pad-1 conv runs K5:
Inception v1's conv2/3x3 and each module's 3x3 (10 a forward), Inception
v2's conv2/3x3, each module's 3x3, double3x3a and double3x3b where their
stride is 1 (27).  ``Concat(2)`` joins K5's channels-last outputs with
the other branches' NCHW ones (``torch.cat`` takes either layout).
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import nn
from ..device import DeviceLike
from ._build import Build


def _inception_module(L: Build, n_in: int, cfg, prefix: str) -> nn.Concat:
    """cfg = ((1x1,), (3x3reduce, 3x3), (5x5reduce, 5x5), (pool_proj,))
    (reference Inception_v1.scala inception())."""
    conv = nn.SpatialConvolution
    concat = nn.Concat(2, device=L.dev)
    concat.add(L.seq(
        L(conv, n_in, cfg[0][0], 1, 1, 1, 1).set_name(prefix + "1x1"),
        L(nn.ReLU, True)))
    concat.add(L.seq(
        L(conv, n_in, cfg[1][0], 1, 1, 1, 1).set_name(prefix + "3x3_reduce"),
        L(nn.ReLU, True),
        L(conv, cfg[1][0], cfg[1][1], 3, 3, 1, 1, 1, 1).set_name(
            prefix + "3x3"),
        L(nn.ReLU, True)))
    concat.add(L.seq(
        L(conv, n_in, cfg[2][0], 1, 1, 1, 1).set_name(prefix + "5x5_reduce"),
        L(nn.ReLU, True),
        L(conv, cfg[2][0], cfg[2][1], 5, 5, 1, 1, 2, 2).set_name(
            prefix + "5x5"),
        L(nn.ReLU, True)))
    concat.add(L.seq(
        L(nn.SpatialMaxPooling, 3, 3, 1, 1, 1, 1).ceil(),
        L(conv, n_in, cfg[3][0], 1, 1, 1, 1).set_name(prefix + "pool_proj"),
        L(nn.ReLU, True)))
    return concat


#: Inception v1's modules: (name, input planes, cfg), a max pool after 3b
#: and after 4e
V1_MODULES = (
    ("3a", 192, ((64,), (96, 128), (16, 32), (32,))),
    ("3b", 256, ((128,), (128, 192), (32, 96), (64,))),
    ("4a", 480, ((192,), (96, 208), (16, 48), (64,))),
    ("4b", 512, ((160,), (112, 224), (24, 64), (64,))),
    ("4c", 512, ((128,), (128, 256), (24, 64), (64,))),
    ("4d", 512, ((112,), (144, 288), (32, 64), (64,))),
    ("4e", 528, ((256,), (160, 320), (32, 128), (128,))),
    ("5a", 832, ((256,), (160, 320), (32, 128), (128,))),
    ("5b", 832, ((384,), (192, 384), (48, 128), (128,))))


def InceptionV1NoAuxClassifier(class_num: int = 1000,
                               device: DeviceLike = None,
                               generator: Optional[torch.Generator] = None
                               ) -> nn.Sequential:
    """reference Inception_v1.scala (the no-aux variant of the perf
    harness, DistriOptimizerPerf.scala:32); 3×224×224 input."""
    L = Build(device, generator)
    conv = nn.SpatialConvolution
    model = L.seq(
        L(conv, 3, 64, 7, 7, 2, 2, 3, 3).set_name("conv1/7x7_s2"),
        L(nn.ReLU, True),
        L(nn.SpatialMaxPooling, 3, 3, 2, 2).ceil(),
        L(nn.SpatialCrossMapLRN, 5, 0.0001, 0.75),
        L(conv, 64, 64, 1, 1, 1, 1).set_name("conv2/3x3_reduce"),
        L(nn.ReLU, True),
        L(conv, 64, 192, 3, 3, 1, 1, 1, 1).set_name("conv2/3x3"),
        L(nn.ReLU, True),
        L(nn.SpatialCrossMapLRN, 5, 0.0001, 0.75),
        L(nn.SpatialMaxPooling, 3, 3, 2, 2).ceil())
    for name, n_in, cfg in V1_MODULES:
        model.add(_inception_module(L, n_in, cfg, f"inception_{name}/"))
        if name in ("3b", "4e"):
            model.add(L(nn.SpatialMaxPooling, 3, 3, 2, 2).ceil())
    model.add(L(nn.SpatialAveragePooling, 7, 7, 1, 1))
    model.add(L(nn.Dropout, 0.4))
    model.add(L(nn.View, 1024))
    model.add(L(nn.Linear, 1024, class_num).set_name("loss3/classifier"))
    model.add(L(nn.LogSoftMax))
    return model


Inception_v1 = InceptionV1NoAuxClassifier


def _conv_bn_relu(L: Build, seq: nn.Sequential, n_in: int, n_out: int,
                  k: int, s: int, p: int, name: str):
    seq.add(L(nn.SpatialConvolution, n_in, n_out, k, k, s, s, p, p)
            .set_name(name))
    seq.add(L(nn.SpatialBatchNormalization, n_out, 1e-3).set_name(
        name + "/bn"))
    seq.add(L(nn.ReLU, True))
    return seq


def _inception_module_v2(L: Build, n_in: int, cfg, prefix: str) -> nn.Concat:
    """Inception-BN module (reference Inception_v2.scala
    Inception_Layer_v2): cfg = ((1x1,), (3x3reduce, 3x3), (d3x3reduce,
    d3x3), (pool_kind, proj)).  The 5×5 becomes a double 3×3 tower; a cfg
    with 1x1 = 0 and proj = 0 is the stride-2 grid reduction."""
    reduce_grid = cfg[3][0] == "max" and cfg[3][1] == 0
    stride = 2 if reduce_grid else 1
    concat = nn.Concat(2, device=L.dev)
    if cfg[0][0] != 0:
        concat.add(_conv_bn_relu(L, L.seq(), n_in, cfg[0][0], 1, 1, 0,
                                 prefix + "1x1"))
    c3 = _conv_bn_relu(L, L.seq(), n_in, cfg[1][0], 1, 1, 0,
                       prefix + "3x3_reduce")
    _conv_bn_relu(L, c3, cfg[1][0], cfg[1][1], 3, stride, 1, prefix + "3x3")
    concat.add(c3)
    c33 = _conv_bn_relu(L, L.seq(), n_in, cfg[2][0], 1, 1, 0,
                        prefix + "double3x3_reduce")
    _conv_bn_relu(L, c33, cfg[2][0], cfg[2][1], 3, 1, 1,
                  prefix + "double3x3a")
    _conv_bn_relu(L, c33, cfg[2][1], cfg[2][1], 3, stride, 1,
                  prefix + "double3x3b")
    concat.add(c33)
    pool = L.seq()
    if cfg[3][0] == "max":
        if cfg[3][1] != 0:
            pool.add(L(nn.SpatialMaxPooling, 3, 3, 1, 1, 1, 1).ceil())
        else:
            pool.add(L(nn.SpatialMaxPooling, 3, 3, 2, 2).ceil())
    else:
        pool.add(L(nn.SpatialAveragePooling, 3, 3, 1, 1, 1, 1,
                   ceil_mode=True))
    if cfg[3][1] != 0:
        _conv_bn_relu(L, pool, n_in, cfg[3][1], 1, 1, 0, prefix + "pool_proj")
    concat.add(pool)
    return concat


#: Inception v2's modules: (name, input planes, cfg); 3c and 4e reduce
#: the grid
V2_MODULES = (
    ("3a", 192, ((64,), (64, 64), (64, 96), ("avg", 32))),
    ("3b", 256, ((64,), (64, 96), (64, 96), ("avg", 64))),
    ("3c", 320, ((0,), (128, 160), (64, 96), ("max", 0))),
    ("4a", 576, ((224,), (64, 96), (96, 128), ("avg", 128))),
    ("4b", 576, ((192,), (96, 128), (96, 128), ("avg", 128))),
    ("4c", 576, ((160,), (128, 160), (128, 160), ("avg", 96))),
    ("4d", 576, ((96,), (128, 192), (160, 192), ("avg", 96))),
    ("4e", 576, ((0,), (128, 192), (192, 256), ("max", 0))),
    ("5a", 1024, ((352,), (192, 320), (160, 224), ("avg", 128))),
    ("5b", 1024, ((352,), (192, 320), (192, 224), ("max", 128))))


def InceptionV2NoAuxClassifier(class_num: int = 1000,
                               device: DeviceLike = None,
                               generator: Optional[torch.Generator] = None
                               ) -> nn.Sequential:
    """Inception-BN (reference Inception_v2.scala
    Inception_v2_NoAuxClassifier:107-150); 3×224×224 input."""
    L = Build(device, generator)
    model = L.seq()
    _conv_bn_relu(L, model, 3, 64, 7, 2, 3, "conv1/7x7_s2")
    model.add(L(nn.SpatialMaxPooling, 3, 3, 2, 2).ceil())
    _conv_bn_relu(L, model, 64, 64, 1, 1, 0, "conv2/3x3_reduce")
    _conv_bn_relu(L, model, 64, 192, 3, 1, 1, "conv2/3x3")
    model.add(L(nn.SpatialMaxPooling, 3, 3, 2, 2).ceil())
    for name, n_in, cfg in V2_MODULES:
        model.add(_inception_module_v2(L, n_in, cfg, f"inception_{name}/"))
    model.add(L(nn.SpatialAveragePooling, 7, 7, 1, 1, ceil_mode=True))
    model.add(L(nn.View, 1024).set_num_input_dims(3))
    model.add(L(nn.Linear, 1024, class_num).set_name("loss3/classifier"))
    model.add(L(nn.LogSoftMax))
    return model


Inception_v2 = InceptionV2NoAuxClassifier
