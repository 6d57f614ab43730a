"""ResNet (counterpart of ``bigdl_tpu/models/resnet.py``; reference
models/resnet/ResNet.scala): the CIFAR-10 basic-block variant
(``ResNetCifar``, depth 6n+2, shortcut type A/B/C) and the ImageNet
ResNet-50 bottleneck variant (``ResNet50``, with the conv7 stem or the
equivalent space-to-depth stem).

Every layer is built on one device with draws from one generator, in
the JAX builder's order, so a seed gives the same weights on the CPU
and on the card.  The JAX package's ``_acc_dtype`` has no counterpart:
``F.conv2d`` has no preferred output type and accumulates in f32 for
both f32 and bf16 inputs.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import nn
from ..device import DeviceLike
from ..nn.initialization import ONE_D, OUT_IN_KW_KH, RandomUniform
from ._build import Build


def _shortcut(L: Build, n_in: int, n_out: int, stride: int,
              shortcut_type: str):
    use_conv = (shortcut_type == "C"
                or (shortcut_type == "B" and n_in != n_out))
    if use_conv:
        return L.seq(
            L(nn.SpatialConvolution, n_in, n_out, 1, 1, stride, stride),
            L(nn.SpatialBatchNormalization, n_out))
    if n_in != n_out:
        # type A: identity with stride + zero-padded channels
        return L.seq(
            L(nn.SpatialAveragePooling, 1, 1, stride, stride),
            nn.Concat(2, L(nn.Identity), L(nn.MulConstant, 0.0),
                      device=L.dev))
    return L(nn.Identity)


def _residual(L: Build, s, n_in: int, n_out: int, stride: int,
              shortcut_type: str):
    return L.seq(
        nn.ConcatTable(s, _shortcut(L, n_in, n_out, stride, shortcut_type),
                       device=L.dev),
        L(nn.CAddTable, True),
        L(nn.ReLU, True))


def _basic_block(L: Build, n_in: int, n_out: int, stride: int,
                 shortcut_type: str):
    s = L.seq(
        L(nn.SpatialConvolution, n_in, n_out, 3, 3, stride, stride, 1, 1),
        L(nn.SpatialBatchNormalization, n_out),
        L(nn.ReLU, True),
        L(nn.SpatialConvolution, n_out, n_out, 3, 3, 1, 1, 1, 1),
        L(nn.SpatialBatchNormalization, n_out))
    return _residual(L, s, n_in, n_out, stride, shortcut_type)


def _bottleneck(L: Build, n_in: int, n_mid: int, n_out: int, stride: int,
                shortcut_type: str):
    s = L.seq(
        L(nn.SpatialConvolution, n_in, n_mid, 1, 1, 1, 1),
        L(nn.SpatialBatchNormalization, n_mid), L(nn.ReLU, True),
        L(nn.SpatialConvolution, n_mid, n_mid, 3, 3, stride, stride, 1, 1),
        L(nn.SpatialBatchNormalization, n_mid), L(nn.ReLU, True),
        L(nn.SpatialConvolution, n_mid, n_out, 1, 1, 1, 1),
        L(nn.SpatialBatchNormalization, n_out))
    return _residual(L, s, n_in, n_out, stride, shortcut_type)


def ResNetCifar(depth: int = 20, class_num: int = 10,
                shortcut_type: str = "A", device: DeviceLike = None,
                generator: Optional[torch.Generator] = None
                ) -> nn.Sequential:
    """The CIFAR-10 ResNet (reference README: depth 20, shortcut A)."""
    if (depth - 2) % 6:
        raise ValueError(f"depth must be 6n+2, got {depth}")
    n = (depth - 2) // 6
    L = Build(device, generator)
    model = L.seq(
        L(nn.SpatialConvolution, 3, 16, 3, 3, 1, 1, 1, 1),
        L(nn.SpatialBatchNormalization, 16),
        L(nn.ReLU, True))

    def layer(n_in, n_out, count, stride):
        seq = L.seq(_basic_block(L, n_in, n_out, stride, shortcut_type))
        for _ in range(1, count):
            seq.add(_basic_block(L, n_out, n_out, 1, shortcut_type))
        return seq

    model.add(layer(16, 16, n, 1))
    model.add(layer(16, 32, n, 2))
    model.add(layer(32, 64, n, 2))
    model.add(L(nn.SpatialAveragePooling, 8, 8, 1, 1))
    model.add(L(nn.View, 64))
    model.add(L(nn.Linear, 64, class_num))
    model.add(L(nn.LogSoftMax))
    return model


class SpaceToDepthStem(nn.TensorModule):
    """The ImageNet stem's 7x7/stride-2 conv rewritten exactly as a
    4x4/stride-1 conv over space-to-depth(2) input: (B, 3, H, W) becomes
    (B, 12, H/2, W/2), and the 7x7/s2 kernel a 4x4/s1 kernel over 12
    channels with (2, 1) padding.  The same function as the conv7 stem
    (weights remapped by :meth:`weight_from_conv7`); the taps that fall
    outside the 7x7 window are masked inside the forward, so they add
    nothing and get a zero gradient."""

    def __init__(self, n_output_plane: int = 64, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device)
        self.n_output_plane = n_output_plane
        w = RandomUniform().init((n_output_plane, 12, 4, 4), OUT_IN_KW_KH,
                                 generator)
        # zero the out-of-window taps: a fresh stem stays inside the
        # conv7 function family
        self._register_param("weight", w * self._valid_tap_mask())
        self._register_param("bias", RandomUniform().init(
            (n_output_plane,), ONE_D, generator))

    @staticmethod
    @functools.lru_cache(maxsize=None)
    def _valid_tap_mask() -> torch.Tensor:
        """(12, 4, 4) float32 on the CPU: 1 where the s2d tap maps to a
        real 7x7 tap, 0 where the bijection leaves it out — derived from
        the remap itself.  Cached: it is a constant."""
        ones = SpaceToDepthStem.weight_from_conv7(np.ones((1, 3, 7, 7)))
        return (ones[0] != 0).to(torch.float32)

    @staticmethod
    def weight_from_conv7(w7):
        """Remap an (O, 3, 7, 7) stem weight to the equivalent
        (O, 12, 4, 4) s2d weight: W[o, (c*2+di)*2+dj, m, n] =
        W7[o, c, 2m+di-1, 2n+dj-1], zero where the 7x7 index falls
        outside [0, 7).  Returns a tensor of w7's dtype (float32 for a
        numpy input) on the CPU."""
        t7 = torch.as_tensor(w7)
        w = t7.detach().to("cpu", torch.float32).numpy()
        o = w.shape[0]
        ws = np.zeros((o, 3, 2, 2, 4, 4), np.float32)
        for m in range(4):
            for di in range(2):
                kh = 2 * m + di - 1
                if not 0 <= kh < 7:
                    continue
                for n in range(4):
                    for dj in range(2):
                        kw = 2 * n + dj - 1
                        if not 0 <= kw < 7:
                            continue
                        ws[:, :, di, dj, m, n] = w[:, :, kh, kw]
        dtype = (t7.dtype if isinstance(w7, torch.Tensor)
                 and t7.is_floating_point() else torch.float32)
        return torch.from_numpy(ws.reshape(o, 12, 4, 4)).to(dtype)

    def _compute(self, params, x):
        squeeze = x.dim() == 3
        if squeeze:
            x = x[None]
        b, c, h, w = x.shape
        if h % 2 or w % 2:
            raise ValueError(
                f"SpaceToDepthStem needs even spatial dims, got {(h, w)}; "
                "use the conv7 stem (or pad) for odd inputs")
        xs = x.reshape(b, c, h // 2, 2, w // 2, 2)
        xs = xs.permute(0, 1, 3, 5, 2, 4).reshape(b, c * 4, h // 2, w // 2)
        wt = params["weight"]
        wt = wt * self._valid_tap_mask().to(wt.device, wt.dtype)
        y = F.conv2d(F.pad(xs.to(wt.dtype), (2, 1, 2, 1)), wt).to(wt.dtype)
        y = y + params["bias"][None, :, None, None]
        return y[0] if squeeze else y


def ResNet50(class_num: int = 1000, shortcut_type: str = "B",
             stem: str = "conv7", device: DeviceLike = None,
             generator: Optional[torch.Generator] = None) -> nn.Sequential:
    """ImageNet ResNet-50 (reference ResNet.scala imagenet path).
    ``stem="s2d"`` swaps the 7x7/s2 first conv for the identical
    :class:`SpaceToDepthStem`."""
    if stem not in ("conv7", "s2d"):
        raise ValueError(f"stem must be 'conv7' or 's2d', got {stem!r}")
    cfg = [(64, 256, 3, 1), (128, 512, 4, 2), (256, 1024, 6, 2),
           (512, 2048, 3, 2)]
    L = Build(device, generator)
    first = (L(SpaceToDepthStem, 64) if stem == "s2d"
             else L(nn.SpatialConvolution, 3, 64, 7, 7, 2, 2, 3, 3))
    model = L.seq(
        first,
        L(nn.SpatialBatchNormalization, 64),
        L(nn.ReLU, True),
        L(nn.SpatialMaxPooling, 3, 3, 2, 2, 1, 1))
    n_in = 64
    for n_mid, n_out, count, stride in cfg:
        seq = L.seq(_bottleneck(L, n_in, n_mid, n_out, stride, shortcut_type))
        for _ in range(1, count):
            seq.add(_bottleneck(L, n_out, n_mid, n_out, 1, shortcut_type))
        model.add(seq)
        n_in = n_out
    model.add(L(nn.SpatialAveragePooling, 7, 7, 1, 1))
    model.add(L(nn.View, 2048))
    model.add(L(nn.Linear, 2048, class_num))
    model.add(L(nn.LogSoftMax))
    return model
