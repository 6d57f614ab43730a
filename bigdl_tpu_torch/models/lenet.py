"""LeNet-5 (counterpart of ``bigdl_tpu/models/lenet.py``; reference
models/lenet/LeNet5.scala), and ``lenet_graph``, the same network built
with the graph API.

conv(1→6, 5×5) → tanh → maxpool → conv(6→12, 5×5) → tanh → maxpool →
fc(12·4·4→100) → tanh → fc(100→10) → logsoftmax.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import nn
from ..device import DeviceLike, resolve_device


def LeNet5(class_num: int = 10, device: DeviceLike = None,
           generator: Optional[torch.Generator] = None) -> nn.Sequential:
    dev = resolve_device(device)
    kw = dict(device=dev)
    pk = dict(device=dev, generator=generator)
    return nn.Sequential(
        nn.Reshape([1, 28, 28], **kw),
        nn.SpatialConvolution(1, 6, 5, 5, **pk).set_name("conv1_5x5"),
        nn.Tanh(**kw),
        nn.SpatialMaxPooling(2, 2, 2, 2, **kw),
        nn.SpatialConvolution(6, 12, 5, 5, **pk).set_name("conv2_5x5"),
        nn.Tanh(**kw),
        nn.SpatialMaxPooling(2, 2, 2, 2, **kw),
        nn.Reshape([12 * 4 * 4], **kw),
        nn.Linear(12 * 4 * 4, 100, **pk).set_name("fc_1"),
        nn.Tanh(**kw),
        nn.Linear(100, class_num, **pk).set_name("fc_2"),
        nn.LogSoftMax(**kw),
        device=dev)


def lenet_graph(class_num: int = 10, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None) -> nn.Graph:
    """The graph-API variant (reference LeNet5.graph): the layers of
    ``LeNet5`` wired node by node; its parameter tree is keyed by the
    sorted nodes ("0" is the input)."""
    dev = resolve_device(device)
    kw = dict(device=dev)
    pk = dict(device=dev, generator=generator)
    inp = nn.Input(**kw)
    x = nn.Reshape([1, 28, 28], **kw)(inp)
    x = nn.SpatialConvolution(1, 6, 5, 5, **pk)(x)
    x = nn.Tanh(**kw)(x)
    x = nn.SpatialMaxPooling(2, 2, 2, 2, **kw)(x)
    x = nn.SpatialConvolution(6, 12, 5, 5, **pk)(x)
    x = nn.Tanh(**kw)(x)
    x = nn.SpatialMaxPooling(2, 2, 2, 2, **kw)(x)
    x = nn.Reshape([12 * 4 * 4], **kw)(x)
    x = nn.Linear(12 * 4 * 4, 100, **pk)(x)
    x = nn.Tanh(**kw)(x)
    x = nn.Linear(100, class_num, **pk)(x)
    out = nn.LogSoftMax(**kw)(x)
    return nn.Graph(inp, out, device=dev)
