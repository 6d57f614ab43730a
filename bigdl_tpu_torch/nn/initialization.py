"""Initialization methods (counterpart of ``bigdl_tpu/nn/initialization.py``).

Every draw is taken on the CPU from an explicit ``torch.Generator``
(``torch.default_generator`` when none is given) and returned as a
float32 CPU tensor; the module that registers it moves it to its
device.  Drawing on the CPU keeps one seed giving the same weights on
either device.  ``torch.Generator`` and the JAX package's RNG give
different numbers from one seed: parity tests carry weights across with
``interop.jax_params.load_param_tree``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


class VariableFormat:
    """Describes which dims are fan-in/fan-out (reference VariableFormat)."""

    def __init__(self, name="Default"):
        self.name = name

    def fans(self, shape):
        if self.name == "ONE_D":
            return shape[0], shape[0]
        if self.name == "IN_OUT":       # (out, in) linear weight
            fan_out, fan_in = shape[0], math.prod(shape[1:])
            return fan_in, fan_out
        if self.name == "OUT_IN":
            fan_in, fan_out = shape[0], math.prod(shape[1:])
            return fan_out, fan_in
        if self.name == "OUT_IN_KW_KH":  # conv weight (out, in, kh, kw)
            receptive = math.prod(shape[2:])
            return shape[1] * receptive, shape[0] * receptive
        if self.name == "IN_OUT_KW_KH":
            receptive = math.prod(shape[2:])
            return shape[0] * receptive, shape[1] * receptive
        n = math.prod(shape)
        d0 = shape[0] if shape else 1
        return n // d0 if d0 else 1, d0


ONE_D = VariableFormat("ONE_D")
IN_OUT = VariableFormat("IN_OUT")
OUT_IN = VariableFormat("OUT_IN")
OUT_IN_KW_KH = VariableFormat("OUT_IN_KW_KH")
IN_OUT_KW_KH = VariableFormat("IN_OUT_KW_KH")
DEFAULT_FORMAT = VariableFormat("Default")


def _gen(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None else torch.default_generator


class InitializationMethod:
    def init(self, shape, fmt: VariableFormat = DEFAULT_FORMAT,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        raise NotImplementedError


class Zeros(InitializationMethod):
    def init(self, shape, fmt=DEFAULT_FORMAT, generator=None):
        return torch.zeros(shape, dtype=torch.float32)


class Ones(InitializationMethod):
    def init(self, shape, fmt=DEFAULT_FORMAT, generator=None):
        return torch.ones(shape, dtype=torch.float32)


class ConstInitMethod(InitializationMethod):
    def __init__(self, value):
        self.value = value

    def init(self, shape, fmt=DEFAULT_FORMAT, generator=None):
        return torch.full(shape, float(self.value), dtype=torch.float32)


class RandomUniform(InitializationMethod):
    """U(lower, upper); no-arg variant scales by 1/sqrt(fan_in) like the
    reference's default torch init."""

    def __init__(self, lower=None, upper=None):
        self.lower, self.upper = lower, upper

    def init(self, shape, fmt=DEFAULT_FORMAT, generator=None):
        if self.lower is None:
            fan_in, _ = fmt.fans(shape)
            stdv = 1.0 / math.sqrt(max(fan_in, 1))
            lo, hi = -stdv, stdv
        else:
            lo, hi = self.lower, self.upper
        return torch.empty(shape, dtype=torch.float32).uniform_(
            lo, hi, generator=_gen(generator))


class RandomNormal(InitializationMethod):
    def __init__(self, mean=0.0, stdv=1.0):
        self.mean, self.stdv = mean, stdv

    def init(self, shape, fmt=DEFAULT_FORMAT, generator=None):
        return torch.empty(shape, dtype=torch.float32).normal_(
            self.mean, self.stdv, generator=_gen(generator))


class Xavier(InitializationMethod):
    """Glorot uniform (reference InitializationMethod.scala Xavier)."""

    def init(self, shape, fmt=DEFAULT_FORMAT, generator=None):
        fan_in, fan_out = fmt.fans(shape)
        stdv = math.sqrt(6.0 / (fan_in + fan_out))
        return torch.empty(shape, dtype=torch.float32).uniform_(
            -stdv, stdv, generator=_gen(generator))


class MsraFiller(InitializationMethod):
    """He init (reference MsraFiller): N(0, 2 / n), n the mean of the
    fans or fan-in alone."""

    def __init__(self, variance_norm_average=True):
        self.avg = variance_norm_average

    def init(self, shape, fmt=DEFAULT_FORMAT, generator=None):
        fan_in, fan_out = fmt.fans(shape)
        n = (fan_in + fan_out) / 2.0 if self.avg else fan_in
        std = math.sqrt(2.0 / max(n, 1))
        return torch.empty(shape, dtype=torch.float32).normal_(
            0.0, std, generator=_gen(generator))


class BilinearFiller(InitializationMethod):
    """Bilinear upsampling kernel for deconvolution (reference
    BilinearFiller); no randomness."""

    def init(self, shape, fmt=DEFAULT_FORMAT, generator=None):
        assert len(shape) >= 2
        kh, kw = shape[-2], shape[-1]
        f = math.ceil(kw / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = torch.arange(kh * kw, dtype=torch.float64)
        x, y = i % kw, torch.div(i, kw, rounding_mode="floor")
        val = (1 - (x / f - c).abs()) * (1 - (y / f - c).abs())
        return val.to(torch.float32).expand(
            math.prod(shape[:-2]), kh * kw).reshape(shape).clone()
