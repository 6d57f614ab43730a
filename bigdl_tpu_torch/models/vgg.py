"""VGG for CIFAR-10 (counterpart of ``bigdl_tpu/models/vgg.py``;
reference models/vgg/VggForCifar10.scala) and VGG-16/19 (the perf
harness's configs).  Every conv is 3×3 stride 1 pad 1, so under the
``"pallas"`` conv impl every one runs K5 (VGG-16: 13 a forward; the
first one's input is the data, so a training step has 12 dX).
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import nn
from ..device import DeviceLike
from ._build import Build

VGG16 = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512, "M"]
VGG19 = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]


def VggForCifar10(class_num: int = 10, device: DeviceLike = None,
                  generator: Optional[torch.Generator] = None
                  ) -> nn.Sequential:
    """reference models/vgg/VggForCifar10.scala; 3×32×32 input."""
    L = Build(device, generator)
    model = L.seq()
    n_in = 3
    for v in VGG16:
        if v == "M":
            model.add(L(nn.SpatialMaxPooling, 2, 2, 2, 2).ceil())
        else:
            model.add(L(nn.SpatialConvolution, n_in, v, 3, 3, 1, 1, 1, 1))
            model.add(L(nn.SpatialBatchNormalization, v, 1e-3))
            model.add(L(nn.ReLU, True))
            n_in = v
    model.add(L(nn.View, 512))
    model.add(L.seq(
        L(nn.Dropout, 0.5), L(nn.Linear, 512, 512),
        L(nn.BatchNormalization, 512), L(nn.ReLU, True),
        L(nn.Dropout, 0.5), L(nn.Linear, 512, class_num),
        L(nn.LogSoftMax)))
    return model


def _vgg_imagenet(cfg, class_num: int, device: DeviceLike,
                  generator: Optional[torch.Generator]) -> nn.Sequential:
    L = Build(device, generator)
    model = L.seq()
    n_in = 3
    for v in cfg:
        if v == "M":
            model.add(L(nn.SpatialMaxPooling, 2, 2, 2, 2))
        else:
            model.add(L(nn.SpatialConvolution, n_in, v, 3, 3, 1, 1, 1, 1))
            model.add(L(nn.ReLU, True))
            n_in = v
    model.add(L(nn.View, 512 * 7 * 7))
    model.add(L(nn.Linear, 512 * 7 * 7, 4096))
    model.add(L(nn.Threshold, 0, 1e-6))
    model.add(L(nn.Dropout, 0.5))
    model.add(L(nn.Linear, 4096, 4096))
    model.add(L(nn.Threshold, 0, 1e-6))
    model.add(L(nn.Dropout, 0.5))
    model.add(L(nn.Linear, 4096, class_num))
    model.add(L(nn.LogSoftMax))
    return model


def Vgg16(class_num: int = 1000, device: DeviceLike = None,
          generator: Optional[torch.Generator] = None) -> nn.Sequential:
    """The perf harness's vgg16; 3×224×224 input."""
    return _vgg_imagenet(VGG16, class_num, device, generator)


def Vgg19(class_num: int = 1000, device: DeviceLike = None,
          generator: Optional[torch.Generator] = None) -> nn.Sequential:
    """The perf harness's vgg19; 3×224×224 input."""
    return _vgg_imagenet(VGG19, class_num, device, generator)
