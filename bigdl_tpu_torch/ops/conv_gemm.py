"""Convolution as a sum of shifted matmuls, the "k² GEMM" lowering
(counterpart of ``bigdl_tpu/ops/conv_gemm.py``).

A k×k conv at stride s is

    y[b, ho, wo, :] = Σ_{dy, dx}  x[b, ho·s+dy, wo·s+dx, :] @ w[dy, dx]

k² matmuls of (B·Ho·Wo, Cin) by (Cin, Cout) on strided slices of the
padded input, accumulated in float32 (float64 for float64 inputs).  It
is SpatialConvolution's ``"gemm"`` impl, and its 3×3 stride-1 case is
the plain version of kernel K5 (``ops/conv3x3.py``).  Plain PyTorch;
the products run in the accumulation dtype, so bf16 inputs give the
exact products the JAX package's ``preferred_element_type=f32`` does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def same_pads(size: int, k: int, s: int):
    """XLA's SAME padding of one spatial dim: (before, after), the odd
    one after."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv2d_gemm_nhwc(x: torch.Tensor, w: torch.Tensor, stride=(1, 1),
                     padding=(0, 0)) -> torch.Tensor:
    """NHWC conv via k² accumulated matmuls.

    x: [B, H, W, Cin]; w: [kh, kw, Cin, Cout] (HWIO); stride (sh, sw);
    padding (ph, pw) on both sides, or ``"SAME"``.  Returns
    [B, Ho, Wo, Cout] in x's dtype."""
    kh, kw = w.shape[:2]
    sh, sw = stride
    if padding == "SAME":
        pads = (same_pads(x.shape[1], kh, sh),
                same_pads(x.shape[2], kw, sw))
    else:
        ph, pw = padding
        pads = ((ph, ph), (pw, pw))
    if any(p for pair in pads for p in pair):
        x_p = F.pad(x, (0, 0, *pads[1], *pads[0]))
    else:
        x_p = x
    B, H, W, _ = x_p.shape
    ho = (H - kh) // sh + 1
    wo = (W - kw) // sw + 1
    acc_t = torch.float64 if x.dtype == torch.float64 else torch.float32
    acc = None
    for dy in range(kh):
        for dx in range(kw):
            xs = x_p[:, dy:dy + (ho - 1) * sh + 1:sh,
                     dx:dx + (wo - 1) * sw + 1:sw, :]
            term = torch.matmul(xs.to(acc_t), w[dy, dx].to(acc_t))
            acc = term if acc is None else acc + term
    return acc.to(x.dtype)


def conv2d_gemm_nchw(x: torch.Tensor, w: torch.Tensor, stride=(1, 1),
                     padding=(0, 0)) -> torch.Tensor:
    """NCHW/OIHW wrapper: one transpose on each side of the NHWC core."""
    y = conv2d_gemm_nhwc(x.permute(0, 2, 3, 1), w.permute(2, 3, 1, 0),
                         stride=stride, padding=padding)
    return y.permute(0, 3, 1, 2)
