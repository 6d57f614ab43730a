"""Pooling layers (counterpart of ``bigdl_tpu/nn/pooling.py``; reference
nn/SpatialMaxPooling.scala:43, SpatialAveragePooling.scala,
VolumetricMaxPooling.scala, RoiPooling.scala).

NCHW (NCDHW for the volumetric pool).  The JAX layers pad each side on
its own (ceil mode pads the right side further, ``pad=-1`` is TF's SAME)
and reduce over the padded input (``lax.reduce_window``).
``F.max_pool2d``/``F.avg_pool2d`` pad symmetrically, so the pads are
applied here with ``F.pad`` (-inf for max, 0 for the sums) and the pool
runs with padding 0.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .module import AbstractModule, TensorModule


def _pool_out(size, k, s, pad, ceil_mode):
    f = math.ceil if ceil_mode else math.floor
    out = int(f((size + 2 * pad - k) / s)) + 1
    if ceil_mode and pad > 0 and (out - 1) * s >= size + pad:
        out -= 1
    return out


def _pool_pads(size, k, s, pad, ceil_mode):
    """Torch-style padding: explicit pad both sides + extra right pad in
    ceil mode so the window count matches.  ``pad=-1`` means TF-style
    SAME (out = ceil(size/stride), asymmetric pad, extra on the right)."""
    if pad == -1:
        out = -(-size // s)
        total = max((out - 1) * s + k - size, 0)
        return (total // 2, total - total // 2)
    out = _pool_out(size, k, s, pad, ceil_mode)
    needed = (out - 1) * s + k - size - pad
    return (pad, max(needed, pad))


def _windows(x, kh, kw, dh, dw, pad_h, pad_w, ceil_mode):
    """The (top, bottom) and (left, right) pads of an NCHW input."""
    return (_pool_pads(x.shape[2], kh, dh, pad_h, ceil_mode),
            _pool_pads(x.shape[3], kw, dw, pad_w, ceil_mode))


class SpatialMaxPooling(TensorModule):
    """NCHW max pool with ceil/floor modes (reference
    nn/SpatialMaxPooling.scala:43)."""

    def __init__(self, kw: int, kh: int, dw: Optional[int] = None,
                 dh: Optional[int] = None, pad_w: int = 0, pad_h: int = 0,
                 global_pooling: bool = False, device=None):
        super().__init__(device)
        self.kw, self.kh = kw, kh
        self.dw = dw if dw is not None else kw
        self.dh = dh if dh is not None else kh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.ceil_mode = False
        self.global_pooling = global_pooling

    def ceil(self):
        self.ceil_mode = True
        return self

    def floor(self):
        self.ceil_mode = False
        return self

    def _compute(self, params, x):
        squeeze = x.dim() == 3
        if squeeze:
            x = x[None]
        kh, kw = self.kh, self.kw
        if self.global_pooling:
            kh, kw = x.shape[2], x.shape[3]
        ph, pw = _windows(x, kh, kw, self.dh, self.dw, self.pad_h,
                          self.pad_w, self.ceil_mode)
        if any(ph + pw):
            x = F.pad(x, (*pw, *ph), value=float("-inf"))
        y = F.max_pool2d(x, (kh, kw), (self.dh, self.dw))
        return y[0] if squeeze else y


class SpatialAveragePooling(TensorModule):
    """NCHW average pool (reference nn/SpatialAveragePooling.scala).
    ``count_include_pad`` follows the reference default (True); SAME
    (``pad=-1``) divides by the count of real inputs, as TF does."""

    def __init__(self, kw: int, kh: int, dw: int = 1, dh: int = 1,
                 pad_w: int = 0, pad_h: int = 0, global_pooling: bool = False,
                 ceil_mode: bool = False, count_include_pad: bool = True,
                 divide: bool = True, device=None):
        super().__init__(device)
        self.kw, self.kh, self.dw, self.dh = kw, kh, dw, dh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.global_pooling = global_pooling
        self.ceil_mode = ceil_mode
        self.count_include_pad = count_include_pad
        self.divide = divide

    def ceil(self):
        self.ceil_mode = True
        return self

    def _compute(self, params, x):
        squeeze = x.dim() == 3
        if squeeze:
            x = x[None]
        kh, kw = self.kh, self.kw
        if self.global_pooling:
            kh, kw = x.shape[2], x.shape[3]
        ph, pw = _windows(x, kh, kw, self.dh, self.dw, self.pad_h,
                          self.pad_w, self.ceil_mode)
        pads = (*pw, *ph)
        window, stride = (kh, kw), (self.dh, self.dw)
        xp = F.pad(x, pads) if any(pads) else x
        sums = F.avg_pool2d(xp, window, stride, divisor_override=1)
        if not self.divide:
            y = sums
        elif self.count_include_pad and not (self.pad_h == -1
                                             or self.pad_w == -1):
            y = sums / (kh * kw)
        else:
            # the count of real inputs under each window: one plane,
            # broadcast over batch and channels
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                              device=x.device)
            counts = F.avg_pool2d(F.pad(ones, pads) if any(pads) else ones,
                                  window, stride, divisor_override=1)
            y = sums / counts
        return y[0] if squeeze else y


class VolumetricMaxPooling(TensorModule):
    """NCDHW max pool (reference nn/VolumetricMaxPooling.scala), padded
    with -inf on both sides of each dim, as ``lax.reduce_window``'s
    -inf init pads."""

    def __init__(self, k_t: int, k_w: int, k_h: int, d_t: Optional[int] = None,
                 d_w: Optional[int] = None, d_h: Optional[int] = None,
                 pad_t: int = 0, pad_w: int = 0, pad_h: int = 0, device=None):
        super().__init__(device)
        self.k = (k_t, k_h, k_w)
        self.d = (d_t or k_t, d_h or k_h, d_w or k_w)
        self.pad = (pad_t, pad_h, pad_w)

    def _compute(self, params, x):
        squeeze = x.dim() == 4
        if squeeze:
            x = x[None]
        pt, ph, pw = self.pad
        if pt or ph or pw:
            x = F.pad(x, (pw, pw, ph, ph, pt, pt), value=float("-inf"))
        y = F.max_pool3d(x, self.k, self.d)
        return y[0] if squeeze else y


class RoiPooling(AbstractModule):
    """ROI max pooling (reference nn/RoiPooling.scala).

    Input: ``Table(features (N, C, H, W), rois (R, 5))``, each roi row
    (1-based batch index, x1, y1, x2, y2) in input pixels.  Output (R, C,
    pooled_h, pooled_w): each cell the max over its bin, 0 for an empty
    bin.  Corners round half to even (``torch.round``, as ``jnp.round``),
    bins are ``floor``/``ceil`` of f32 multiples of the roi's size over
    the pooled size, clipped to the image.  The bins of a cell are a row
    range times a column range, so the max runs over the columns, then
    over the rows: (R, C, H, pooled_w) in between."""

    def __init__(self, pooled_w: int, pooled_h: int, spatial_scale: float,
                 device=None):
        super().__init__(device)
        self.pw, self.ph = pooled_w, pooled_h
        self.spatial_scale = spatial_scale

    def _compute(self, params, inp):
        data, rois = inp[1], inp[2]
        H, W = data.shape[2], data.shape[3]
        rois = rois.to(torch.float32)
        batch = rois[:, 0].to(torch.int64) - 1
        x1, y1, x2, y2 = (torch.round(rois[:, i] * self.spatial_scale)
                          .to(torch.int32) for i in range(1, 5))
        roi_h = torch.clamp(y2 - y1 + 1, min=1)
        roi_w = torch.clamp(x2 - x1 + 1, min=1)

        def bins(start, size, n, limit):
            """(R, n) bin starts and ends, clipped to [0, limit]."""
            step = size.to(torch.float32) / n
            p = torch.arange(n, device=data.device, dtype=torch.float32)
            lo = torch.floor(p[None] * step[:, None]).to(torch.int32)
            hi = torch.ceil((p[None] + 1) * step[:, None]).to(torch.int32)
            return ((lo + start[:, None]).clamp(0, limit),
                    (hi + start[:, None]).clamp(0, limit))

        h0, h1 = bins(y1, roi_h, self.ph, H)
        w0, w1 = bins(x1, roi_w, self.pw, W)
        ys = torch.arange(H, device=data.device, dtype=torch.int32)
        xs = torch.arange(W, device=data.device, dtype=torch.int32)
        hmask = (ys >= h0[..., None]) & (ys < h1[..., None])  # (R, ph, H)
        wmask = (xs >= w0[..., None]) & (xs < w1[..., None])  # (R, pw, W)
        img = data[batch]                                      # (R, C, H, W)
        neg = torch.tensor(float("-inf"), dtype=data.dtype,
                           device=data.device)
        cols = torch.where(wmask[:, None, None], img[:, :, :, None],
                           neg).amax(-1)                     # (R, C, H, pw)
        cells = torch.where(hmask[:, None, :, :, None], cols[:, :, None],
                            neg).amax(3)                     # (R, C, ph, pw)
        empty = ~(hmask.any(-1)[:, :, None] & wmask.any(-1)[:, None, :])
        return torch.where(empty[:, None], torch.zeros_like(cells), cells)
