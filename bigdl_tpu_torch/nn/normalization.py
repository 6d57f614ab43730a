"""LayerNorm and RMSNorm (counterpart of ``bigdl_tpu/nn/normalization.py``;
the batch and spatial normalizations are not ported yet)."""
from __future__ import annotations

import torch

from ..device import DeviceLike
from ..ops.layer_norm import fused_layer_norm
from .initialization import ONE_D, Ones, Zeros
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
