"""MNIST autoencoder (counterpart of ``bigdl_tpu/models/autoencoder.py``;
reference models/autoencoder/Autoencoder.scala)."""
from __future__ import annotations

from typing import Optional

import torch

from .. import nn
from ..device import DeviceLike
from ._build import Build


def Autoencoder(class_num: int = 32, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None
                ) -> nn.Sequential:
    """784 → class_num → 784 with a sigmoid reconstruction, trained with
    ``MSECriterion`` against the input (the reference's Train.scala)."""
    L = Build(device, generator)
    return L.seq(
        L(nn.Reshape, [28 * 28]),
        L(nn.Linear, 28 * 28, class_num),
        L(nn.ReLU, True),
        L(nn.Linear, class_num, 28 * 28),
        L(nn.Sigmoid))
