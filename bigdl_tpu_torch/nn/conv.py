"""SpatialConvolution (counterpart of ``bigdl_tpu/nn/conv.py``, trimmed to
the 2-D conv; the dilated, full, map, volumetric and temporal layers are
not ported yet).  NCHW activations and OIHW weights, as in the JAX layer.

``set_conv_impl`` keeps the JAX package's impl names:

* ``"xla"`` (the default, as the JAX ``bigdl.conv.impl`` default is):
  ``F.conv2d``, i.e. cuDNN on the card; the JAX package computes it with
  ``lax.conv_general_dilated``, outside any Pallas kernel;
* ``"xla_nhwc"``: the same call on channels-last activations;
* ``"gemm"``: the k² shifted matmuls of ``ops/conv_gemm.py``;
* ``"pallas"``: kernel K5 (``ops/conv3x3.py``) where it applies, a 3×3
  kernel at stride 1, pad 1, one group; other shapes keep ``F.conv2d``.

K5 is NHWC.  The activation goes in as
``x.contiguous(memory_format=torch.channels_last)``, which copies an
NCHW-contiguous tensor and is free on a channels-last one, and the
output comes back as a channels-last view of K5's NHWC result, so a
chain of K5 layers hands channels-last tensors along.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..device import DeviceLike
from ..ops.conv3x3 import conv3x3_s1_same
from ..ops.conv_gemm import conv2d_gemm_nchw, same_pads
from ..utils.engine import get_property
from .initialization import ONE_D, OUT_IN_KW_KH, RandomUniform
from .module import TensorModule

IMPLS = ("xla", "xla_nhwc", "gemm", "pallas")


class SpatialConvolution(TensorModule):
    """2-D conv, NCHW, group support, explicit pads or ``-1`` for SAME
    (reference nn/SpatialConvolution.scala:42).  ``propagate_back`` is
    accepted for the reference's signature; autograd decides whether a
    gradient reaches the input."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int, stride_w: int = 1,
                 stride_h: int = 1, pad_w: int = 0, pad_h: int = 0,
                 n_group: int = 1, propagate_back: bool = True,
                 w_regularizer=None, b_regularizer=None,
                 with_bias: bool = True, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device)
        if n_input_plane % n_group or n_output_plane % n_group:
            raise ValueError(f"planes {n_input_plane} -> {n_output_plane} "
                             f"do not split into {n_group} groups")
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel_w, self.kernel_h = kernel_w, kernel_h
        self.stride_w, self.stride_h = stride_w, stride_h
        self.pad_w, self.pad_h = pad_w, pad_h
        self.n_group = n_group
        self.propagate_back = propagate_back
        self.with_bias = with_bias
        self.w_regularizer = w_regularizer
        self.b_regularizer = b_regularizer
        # None: the ``bigdl.conv.impl`` property at each call, "xla"
        # when unset (bigdl_tpu/nn/conv.py:89-90)
        self.conv_impl = None
        shape = (n_output_plane, n_input_plane // n_group, kernel_h, kernel_w)
        self._register_param("weight", RandomUniform().init(
            shape, OUT_IN_KW_KH, generator), RandomUniform(), OUT_IN_KW_KH)
        if with_bias:
            self._register_param("bias", RandomUniform().init(
                (n_output_plane,), ONE_D, generator), RandomUniform(), ONE_D)

    def set_conv_impl(self, impl: str):
        if impl not in IMPLS:
            raise ValueError(f"conv impl {impl!r} not in {IMPLS}")
        self.conv_impl = impl
        return self

    def _padding(self):
        if self.pad_w == -1 or self.pad_h == -1:
            return "SAME"
        return (self.pad_h, self.pad_w)

    def _native(self, x, w):
        padding = self._padding()
        stride = (self.stride_h, self.stride_w)
        if padding == "SAME" and stride != (1, 1):
            # F.conv2d takes "same" only at stride 1: pad as XLA's SAME
            # does (the extra row or column on the bottom/right)
            ph = same_pads(x.shape[2], self.kernel_h, self.stride_h)
            pw = same_pads(x.shape[3], self.kernel_w, self.stride_w)
            x, padding = F.pad(x, (*pw, *ph)), 0
        elif padding == "SAME":
            padding = "same"
        return F.conv2d(x, w, None, stride, padding, 1, self.n_group)

    def _conv(self, x, w):
        impl = self.conv_impl
        if impl is None:
            impl = get_property("bigdl.conv.impl", "xla")
        if impl == "gemm" and self.n_group == 1:
            return conv2d_gemm_nchw(x, w, (self.stride_h, self.stride_w),
                                    self._padding())
        if impl == "xla_nhwc" and self.n_group == 1:
            cl = torch.channels_last
            return self._native(x.contiguous(memory_format=cl),
                                w.contiguous(memory_format=cl))
        if (impl == "pallas" and self.n_group == 1
                and (self.kernel_w, self.kernel_h) == (3, 3)
                and (self.stride_w, self.stride_h) == (1, 1)
                and (self.pad_w, self.pad_h) == (1, 1)):
            x_nhwc = x.contiguous(
                memory_format=torch.channels_last).permute(0, 2, 3, 1)
            y = conv3x3_s1_same(x_nhwc, w.permute(2, 3, 1, 0))
            return y.permute(0, 3, 1, 2)
        return self._native(x, w)

    def _compute(self, params, x):
        squeeze = x.dim() == 3   # no-batch mode
        if squeeze:
            x = x[None]
        # mixed precision: compute in the weight dtype, emit the weight
        # dtype, then add the bias
        w = params["weight"]
        y = self._conv(x.to(w.dtype), w).to(w.dtype)
        if self.with_bias:
            y = y + params["bias"][None, :, None, None]
        return y[0] if squeeze else y
