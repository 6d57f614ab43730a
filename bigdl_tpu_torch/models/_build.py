"""The device and generator every layer of one model is built with.

Every zoo model builds its layers on one device with draws from one
generator, in the JAX builder's order, so a seed gives the same weights
on the CPU and on the card."""
from __future__ import annotations

import inspect
from typing import Optional

import torch

from .. import nn
from ..device import DeviceLike, resolve_device


class Build:
    """``L(cls, *args)`` builds ``cls`` on the model's device, drawing
    from the model's generator where ``cls`` takes one."""

    def __init__(self, device: DeviceLike,
                 generator: Optional[torch.Generator]):
        self.dev = resolve_device(device)
        self.gen = generator

    def __call__(self, cls, *args, **kwargs):
        if "generator" in inspect.signature(cls).parameters:
            kwargs["generator"] = self.gen
        return cls(*args, device=self.dev, **kwargs)

    def seq(self, *modules):
        return nn.Sequential(*modules, device=self.dev)
