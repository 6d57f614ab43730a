"""The convolution family (counterpart of ``bigdl_tpu/nn/conv.py``;
reference SpatialConvolution.scala:42 et al.): ``SpatialConvolution``
and its ``SpatialShareConvolution`` and ``SpatialDilatedConvolution``,
the transposed ``SpatialFullConvolution``, ``SpatialConvolutionMap``,
``TemporalConvolution`` on (N, T, F) and ``VolumetricConvolution``
(NCDHW).  NCHW activations and OIHW weights, as in the JAX layers.

The JAX package computes all of these but ``SpatialConvolution``'s
``"pallas"`` impl with ``lax.conv_general_dilated``, outside any Pallas
kernel, so here they are ``F.conv1d``/``conv2d``/``conv3d`` and
``F.conv_transpose2d`` (cuDNN on the card).  ``SpatialShareConvolution``
is ``SpatialConvolution`` (the reference's im2col buffer sharing has
nothing to share here), so under ``"pallas"`` its 3×3 stride-1 pad-1
case runs K5 too.

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

import math
from typing import Optional

import numpy as np
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


class SpatialShareConvolution(SpatialConvolution):
    """reference nn/SpatialShareConvolution.scala — the im2col-buffer
    sharing variant; the same computation, K5 included."""


class SpatialDilatedConvolution(SpatialConvolution):
    """reference nn/SpatialDilatedConvolution.scala: one group, always
    ``F.conv2d`` with the dilation, whatever the conv impl (as the JAX
    layer's ``_conv`` is always ``lax.conv_general_dilated``)."""

    def __init__(self, n_input_plane: int, n_output_plane: int, kw: int,
                 kh: int, dw: int = 1, dh: int = 1, pad_w: int = 0,
                 pad_h: int = 0, dilation_w: int = 1, dilation_h: int = 1,
                 w_regularizer=None, b_regularizer=None, *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(n_input_plane, n_output_plane, kw, kh, dw, dh,
                         pad_w, pad_h, 1, True, w_regularizer,
                         b_regularizer, device=device, generator=generator)
        self.dilation_w, self.dilation_h = dilation_w, dilation_h

    def _conv(self, x, w):
        return F.conv2d(x, w, None, (self.stride_h, self.stride_w),
                        (self.pad_h, self.pad_w),
                        (self.dilation_h, self.dilation_w))


def _batched(x, dims: int):
    """(x with a batch dim, whether one was added) for a layer whose
    sample has ``dims`` dims."""
    return (x[None], True) if x.dim() == dims else (x, False)


class SpatialFullConvolution(TensorModule):
    """Transposed conv / deconv (reference
    nn/SpatialFullConvolution.scala) with the output adjustment
    ``adj_w``/``adj_h`` and groups.  The weight is the reference's
    (in, out / group, kh, kw), which is ``F.conv_transpose2d``'s layout.

    The JAX layer convolves the stride-dilated input with the flipped
    weight at pads (k − 1 − pad, k − 1 − pad + adj).  That is the
    transposed conv's full output (size (in − 1)·stride + k) cut from
    ``pad`` to ``pad + out``, out = (in − 1)·stride − 2·pad + k + adj;
    rows past the full output, where adj > pad, receive nothing and are
    zero.  Cutting the full output takes any ``adj`` (``output_padding``
    must stay below the stride)."""

    def __init__(self, n_input_plane: int, n_output_plane: int, kw: int,
                 kh: int, dw: int = 1, dh: int = 1, pad_w: int = 0,
                 pad_h: int = 0, adj_w: int = 0, adj_h: int = 0,
                 n_group: int = 1, no_bias: bool = False,
                 w_regularizer=None, b_regularizer=None, *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device)
        self.n_input_plane, self.n_output_plane = n_input_plane, n_output_plane
        self.kw, self.kh, self.dw, self.dh = kw, kh, dw, dh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.adj_w, self.adj_h = adj_w, adj_h
        self.n_group = n_group
        self.with_bias = not no_bias
        self.w_regularizer = w_regularizer
        self.b_regularizer = b_regularizer
        shape = (n_input_plane, n_output_plane // n_group, kh, kw)
        self._register_param("weight", RandomUniform().init(
            shape, OUT_IN_KW_KH, generator), RandomUniform(), OUT_IN_KW_KH)
        if self.with_bias:
            self._register_param("bias", RandomUniform().init(
                (n_output_plane,), ONE_D, generator), RandomUniform(), ONE_D)

    def _compute(self, params, x):
        x, squeeze = _batched(x, 3)
        w = params["weight"]
        y = F.conv_transpose2d(x.to(w.dtype), w, None, (self.dh, self.dw),
                               groups=self.n_group)
        out_h = ((x.shape[2] - 1) * self.dh - 2 * self.pad_h + self.kh
                 + self.adj_h)
        out_w = ((x.shape[3] - 1) * self.dw - 2 * self.pad_w + self.kw
                 + self.adj_w)
        extra_h = max(0, self.pad_h + out_h - y.shape[2])
        extra_w = max(0, self.pad_w + out_w - y.shape[3])
        if extra_h or extra_w:
            y = F.pad(y, (0, extra_w, 0, extra_h))
        y = y[:, :, self.pad_h:self.pad_h + out_h,
              self.pad_w:self.pad_w + out_w]
        if self.with_bias:
            y = y + params["bias"][None, :, None, None]
        return y[0] if squeeze else y


class SpatialConvolutionMap(TensorModule):
    """Conv with an explicit input→output connection table (reference
    nn/SpatialConvolutionMap.scala): rows of 1-based (in, out) pairs; a
    dense conv whose weight is masked to the table's connections."""

    def __init__(self, conn_table, kw: int, kh: int, dw: int = 1,
                 dh: int = 1, pad_w: int = 0, pad_h: int = 0, *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device)
        conn = np.asarray(conn_table, dtype=np.int32)
        self.conn = conn
        self.n_input_plane = int(conn[:, 0].max())
        self.n_output_plane = int(conn[:, 1].max())
        self.kw, self.kh, self.dw, self.dh = kw, kh, dw, dh
        self.pad_w, self.pad_h = pad_w, pad_h
        mask = torch.zeros((self.n_output_plane, self.n_input_plane, 1, 1))
        for i, o in conn:
            mask[o - 1, i - 1, 0, 0] = 1.0
        # a constant, not state: no buffer (the JAX layer keeps it out of
        # its buffer tree too)
        self._mask = mask
        n_in_per_out = max(1, len(conn) // max(self.n_output_plane, 1))
        stdv = 1.0 / math.sqrt(kw * kh * n_in_per_out)
        init = RandomUniform(-stdv, stdv)
        self._register_param("weight", init.init(
            (self.n_output_plane, self.n_input_plane, kh, kw),
            generator=generator), init)
        self._register_param("bias", init.init(
            (self.n_output_plane,), generator=generator), init)

    def _compute(self, params, x):
        x, squeeze = _batched(x, 3)
        w = params["weight"]
        w = w * self._mask.to(device=w.device, dtype=w.dtype)
        y = F.conv2d(x.to(w.dtype), w, None, (self.dh, self.dw),
                     (self.pad_h, self.pad_w))
        y = y + params["bias"][None, :, None, None]
        return y[0] if squeeze else y


class VolumetricConvolution(TensorModule):
    """3-D conv, NCDHW (reference nn/VolumetricConvolution.scala)."""

    def __init__(self, n_input_plane: int, n_output_plane: int, k_t: int,
                 k_w: int, k_h: int, d_t: int = 1, d_w: int = 1, d_h: int = 1,
                 pad_t: int = 0, pad_w: int = 0, pad_h: int = 0,
                 with_bias: bool = True, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device)
        self.n_input_plane, self.n_output_plane = n_input_plane, n_output_plane
        self.k = (k_t, k_h, k_w)
        self.d = (d_t, d_h, d_w)
        self.pad = (pad_t, pad_h, pad_w)
        self.with_bias = with_bias
        shape = (n_output_plane, n_input_plane) + self.k
        self._register_param("weight", RandomUniform().init(
            shape, OUT_IN_KW_KH, generator), RandomUniform(), OUT_IN_KW_KH)
        if with_bias:
            self._register_param("bias", RandomUniform().init(
                (n_output_plane,), ONE_D, generator), RandomUniform(), ONE_D)

    def _compute(self, params, x):
        x, squeeze = _batched(x, 4)
        w = params["weight"]
        y = F.conv3d(x.to(w.dtype), w, None, self.d, self.pad)
        if self.with_bias:
            y = y + params["bias"][None, :, None, None, None]
        return y[0] if squeeze else y


class TemporalConvolution(TensorModule):
    """1-D conv over (batch, nInputFrame, inputFrameSize) (reference
    nn/TemporalConvolution.scala); no padding."""

    def __init__(self, input_frame_size: int, output_frame_size: int,
                 kernel_w: int, stride_w: int = 1, *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device)
        self.input_frame_size = input_frame_size
        self.output_frame_size = output_frame_size
        self.kernel_w, self.stride_w = kernel_w, stride_w
        stdv = 1.0 / math.sqrt(kernel_w * input_frame_size)
        init = RandomUniform(-stdv, stdv)
        self._register_param("weight", init.init(
            (output_frame_size, input_frame_size, kernel_w),
            generator=generator), init)
        self._register_param("bias", init.init(
            (output_frame_size,), generator=generator), init)

    def _compute(self, params, x):
        x, squeeze = _batched(x, 2)
        w = params["weight"]
        y = F.conv1d(x.transpose(1, 2).to(w.dtype), w, None,
                     (self.stride_w,))
        y = y.transpose(1, 2) + params["bias"]
        return y[0] if squeeze else y
