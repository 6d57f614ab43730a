"""LayerNorm, RMSNorm and the batch normalizations (counterpart of
``bigdl_tpu/nn/normalization.py``; LRN and the subtractive/divisive
normalizations are not ported yet).

BatchNorm's running statistics are float32 torch buffers under the JAX
keys (``running_mean``, ``running_var``; see ``nn/module.py``).  In
training mode a forward updates them in place from the detached batch
statistics; in eval mode it normalizes with them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..device import DeviceLike
from ..ops.layer_norm import fused_layer_norm
from .initialization import ONE_D, Ones, RandomUniform, Zeros
from .module import TensorModule


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float):
    """``x * rsqrt(mean(x^2) + eps) * weight`` with at-least-f32
    statistics, the normalized row cast back to x's dtype before the
    weight multiply (the HF Llama convention the JAX layer follows)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = (xf * torch.rsqrt(var + eps)).to(x.dtype)
    return normed * weight.to(x.dtype)


class LayerNorm(TensorModule):
    """Layer normalization over the last dimension; the affine form
    runs kernel K4 (``ops/layer_norm.py``)."""

    def __init__(self, n_output: int, eps: float = 1e-5, affine: bool = True,
                 device: DeviceLike = None):
        super().__init__(device)
        self.n_output = n_output
        self.eps = eps
        self.affine = affine
        if affine:
            self._register_param("weight", Ones().init((n_output,), ONE_D))
            self._register_param("bias", Zeros().init((n_output,), ONE_D))

    def _compute(self, params, x):
        if self.affine:
            return fused_layer_norm(x, params["weight"], params["bias"],
                                    self.eps)
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps)


class RMSNorm(TensorModule):
    """Root-mean-square normalization over the last dimension (the
    Llama-family norm): no mean subtraction, no bias."""

    def __init__(self, n_output: int, eps: float = 1e-6,
                 device: DeviceLike = None):
        super().__init__(device)
        self.n_output = n_output
        self.eps = eps
        self._register_param("weight", Ones().init((n_output,), ONE_D))

    def _compute(self, params, x):
        return rms_norm(x, params["weight"], self.eps)


class BatchNormalization(TensorModule):
    """BN over (N, D), feature dim 2 (reference
    nn/BatchNormalization.scala:50).  Plain tensor ops, op for op the JAX
    layer's formula: normalize with the biased batch variance, update the
    running variance with the unbiased one (n / (n - 1)), momentum on the
    batch statistic."""

    _feature_axis = 1

    def __init__(self, n_output: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device)
        self.n_output = n_output
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        if affine:
            self._register_param("weight", RandomUniform(0.0, 1.0).init(
                (n_output,), ONE_D, generator))
            self._register_param("bias", Zeros().init((n_output,), ONE_D))
        self._register_buffer("running_mean", torch.zeros(n_output))
        self._register_buffer("running_var", torch.ones(n_output))

    def _compute(self, params, x):
        axes = tuple(i for i in range(x.dim()) if i != self._feature_axis)
        bshape = [1] * x.dim()
        bshape[self._feature_axis] = self.n_output
        if self.training:
            mean = x.mean(dim=axes)
            var = ((x - mean.reshape(bshape)) ** 2).mean(dim=axes)
            n = math.prod(x.shape[i] for i in axes)
            with torch.no_grad():
                m = self.momentum
                unbiased = var.detach() * n / max(n - 1, 1)
                self.running_mean.copy_((1 - m) * self.running_mean
                                        + m * mean.detach())
                self.running_var.copy_((1 - m) * self.running_var
                                       + m * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean.reshape(bshape)) * torch.rsqrt(
            var + self.eps).reshape(bshape)
        if self.affine:
            y = (y * params["weight"].reshape(bshape)
                 + params["bias"].reshape(bshape))
        return y


class SpatialBatchNormalization(BatchNormalization):
    """BN over NCHW, per channel (reference
    nn/SpatialBatchNormalization.scala)."""
