"""Normalization layers (counterpart of ``bigdl_tpu/nn/normalization.py``;
reference BatchNormalization.scala:50, SpatialBatchNormalization,
SpatialCrossMapLRN, Normalize, L1Penalty, Spatial{Subtractive,Divisive,
Contrastive}Normalization; LayerNorm on kernel K4, ``ops/layer_norm.py``).

BatchNorm's running statistics are float32 torch buffers under the JAX
keys (``running_mean``, ``running_var``; see ``nn/module.py``).  In
training mode a forward updates them in place from the detached batch
statistics; in eval mode it normalizes with them.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

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
            self._register_param("weight", Ones().init((n_output,), ONE_D),
                                 Ones(), ONE_D)
            self._register_param("bias", Zeros().init((n_output,), ONE_D),
                                 Zeros(), ONE_D)

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
        self._register_param("weight", Ones().init((n_output,), ONE_D),
                             Ones(), ONE_D)

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
                (n_output,), ONE_D, generator), RandomUniform(0.0, 1.0),
                ONE_D)
            self._register_param("bias", Zeros().init((n_output,), ONE_D),
                                 Zeros(), ONE_D)
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


class SpatialCrossMapLRN(TensorModule):
    """AlexNet's local response normalization across channels (reference
    nn/SpatialCrossMapLRN.scala): x / (k + alpha / size * the sum of x^2
    over ``size`` channels around) ^ beta, NCHW."""

    def __init__(self, size: int = 5, alpha: float = 1.0, beta: float = 0.75,
                 k: float = 1.0, device: DeviceLike = None):
        super().__init__(device)
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def _compute(self, params, x):
        half = (self.size - 1) // 2
        C = x.shape[1]
        sq = F.pad(torch.square(x), (0, 0, 0, 0, half, self.size - 1 - half))
        sums = sum(sq[:, i:i + C] for i in range(self.size))
        return x / torch.pow(self.k + sums * self.alpha / self.size,
                             self.beta)


class Normalize(TensorModule):
    """Rows divided by their Lp norm plus eps (reference
    nn/Normalize.scala)."""

    def __init__(self, p: float = 2.0, eps: float = 1e-10,
                 device: DeviceLike = None):
        super().__init__(device)
        self.p, self.eps = p, eps

    def _compute(self, params, x):
        if self.p == float("inf"):
            norm = x.abs().amax(dim=-1, keepdim=True)
        else:
            norm = (x.abs() ** self.p).sum(dim=-1, keepdim=True) \
                ** (1.0 / self.p)
        return x / (norm + self.eps)


class _L1Penalty(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale: float):
        ctx.save_for_backward(x)
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g + ctx.scale * torch.sign(x), None


class L1Penalty(TensorModule):
    """The identity forward whose backward adds ``l1weight * sign(x)``
    (divided by x's size with ``size_average``) to the gradient, in
    training mode (reference nn/L1Penalty.scala)."""

    def __init__(self, l1weight: float, size_average: bool = False,
                 provide_output: bool = True, device: DeviceLike = None):
        super().__init__(device)
        self.l1weight = l1weight
        self.size_average = size_average
        self.loss = 0.0

    def _compute(self, params, x):
        if not self.training:
            return x
        scale = self.l1weight / x.numel() if self.size_average \
            else self.l1weight
        return _L1Penalty.apply(x, float(scale))


def _normalized_kernel(kernel) -> np.ndarray:
    k = np.asarray(kernel, np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    return k / k.sum()


def _local_mean(x, kernel: np.ndarray):
    """The kernel-weighted mean of x over each position's neighbourhood
    and every channel, divided at the borders by the kernel's mass that
    lies inside the image (NCHW)."""
    kh, kw = kernel.shape
    k = torch.as_tensor(kernel, dtype=x.dtype, device=x.device)
    pad = (kw // 2, (kw - 1) // 2, kh // 2, (kh - 1) // 2)
    w = k.reshape(1, 1, kh, kw).expand(1, x.shape[1], kh, kw) / x.shape[1]
    mean = F.conv2d(F.pad(x, pad), w)
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    coef = F.conv2d(F.pad(ones, pad), k.reshape(1, 1, kh, kw))
    return mean / coef


def _batched(fn, x):
    """fn over a batch, a CHW input as a batch of one."""
    if x.dim() == 3:
        return fn(x[None])[0]
    return fn(x)


class SpatialSubtractiveNormalization(TensorModule):
    """x minus its local weighted mean (reference
    nn/SpatialSubtractiveNormalization.scala); the default kernel 9 x 9
    ones."""

    def __init__(self, n_input_plane: int = 1, kernel=None,
                 device: DeviceLike = None):
        super().__init__(device)
        self.n_input_plane = n_input_plane
        self.kernel = _normalized_kernel(
            np.ones((9, 9), np.float32) if kernel is None else kernel)

    def _compute(self, params, x):
        return _batched(lambda v: v - _local_mean(v, self.kernel), x)


def _divisive(v, kernel, threshold, thresval):
    std = torch.sqrt(torch.clamp_min(_local_mean(torch.square(v), kernel),
                                     0.0))
    adj = torch.maximum(std, std.mean(dim=(1, 2, 3), keepdim=True))
    adj = torch.where(adj < threshold, torch.full_like(adj, thresval), adj)
    return v / adj


class SpatialDivisiveNormalization(TensorModule):
    """x divided by its local weighted standard deviation, floored at its
    mean over the image and at ``threshold`` (reference
    nn/SpatialDivisiveNormalization.scala)."""

    def __init__(self, n_input_plane: int = 1, kernel=None,
                 threshold: float = 1e-4, thresval: float = 1e-4,
                 device: DeviceLike = None):
        super().__init__(device)
        self.n_input_plane = n_input_plane
        self.kernel = _normalized_kernel(
            np.ones((9, 9), np.float32) if kernel is None else kernel)
        self.threshold, self.thresval = threshold, thresval

    def _compute(self, params, x):
        return _batched(lambda v: _divisive(
            v, self.kernel, self.threshold, self.thresval), x)


class SpatialContrastiveNormalization(SpatialDivisiveNormalization):
    """Subtractive then divisive normalization (reference
    nn/SpatialContrastiveNormalization.scala)."""

    def _compute(self, params, x):
        return _batched(lambda v: _divisive(
            v - _local_mean(v, self.kernel), self.kernel, self.threshold,
            self.thresval), x)


class ImageNormalize(TensorModule):
    """(x - mean) / std per channel on the device, moving NHWC to NCHW
    (``from_layout="NHWC"``) or normalizing NCHW in place; a uint8 input
    is cast to f32, a float one keeps its dtype."""

    def __init__(self, mean, std, from_layout: str = "NHWC",
                 device: DeviceLike = None):
        super().__init__(device)
        if from_layout not in ("NHWC", "NCHW"):
            raise ValueError(f"from_layout {from_layout!r}")
        self.mean = tuple(float(m) for m in np.atleast_1d(mean))
        self.std = tuple(float(s) for s in np.atleast_1d(std))
        self.from_layout = from_layout

    def _compute(self, params, x):
        squeeze = x.dim() == 3
        if squeeze:
            x = x[None]
        dt = x.dtype if x.is_floating_point() else torch.float32
        mean = torch.tensor(self.mean, dtype=dt, device=x.device)
        std = torch.tensor(self.std, dtype=dt, device=x.device)
        x = x.to(dt)
        if self.from_layout == "NHWC":
            x = ((x - mean) / std).permute(0, 3, 1, 2)
        else:
            x = (x - mean[:, None, None]) / std[:, None, None]
        return x[0] if squeeze else x
