"""The 3×3 stride-1 SAME convolution, forward and backward (counterpart
of ``bigdl_tpu/ops/conv3x3_pallas.py``; the name drops "pallas", since
nothing here is Pallas).

Kernel K5, CUDA C++ for ``sm_90a`` (``csrc/conv3x3.cu``, whose header
says what it computes, what bounds it and how), replaces ``_kernel``
(``bigdl_tpu/ops/conv3x3_pallas.py:60``): in bf16 an implicit GEMM on TMA
and wgmma, in f32 an FMA tile loop.

``conv3x3_s1_same(x, w)`` takes NHWC ``x`` and HWIO ``w``, as the JAX
entry point does, and runs one ``torch.autograd.Function``, the
counterpart of that module's ``custom_vjp``:

* forward: K5 on ``x`` and the weights laid out (tap, out, in), f32
  accumulation, the output in x's dtype;
* backward: dX is K5 again, on the output gradient (cast to x's dtype)
  with the spatially flipped, in/out-transposed weights; dW is nine
  products (C, N) × (N, O) over one zero-padded, flattened copy of x and
  one of the gradient (``_conv3x3_dw``), as the JAX package leaves dW to
  XLA.

For CPU tensors the same Function runs the plain version,
``_conv3x3_plain`` (the nine shifted products of ``ops/conv_gemm.py``
with f32 accumulation), forward and dX; a CUDA tensor launches K5 or
raises.  Any B, H, W, C and O, bfloat16 or float32.  The bf16 kernel
reads x through TMA, which needs C a multiple of 8 (at least 16 here)
and a 16-byte-aligned base: where x falls short, the wrapper hands the
kernel a zero-padded (``_pad_channels``) or aligned copy and counts it in
``X_COPIES``.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._support import LaunchCounter, load_cuda_library, on_cpu
from .conv_gemm import conv2d_gemm_nhwc

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: launches of K5, forward and dX alike (CUDA branch only)
LAUNCHES = LaunchCounter("conv3x3")
#: copies of x the bf16 CUDA branch makes for TMA: a channel pad or an
#: aligned copy
X_COPIES = LaunchCounter("conv3x3_x_copies")


def _conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K5's math: NHWC ``x`` and HWIO ``w``, nine shifted products with
    f32 accumulation, the output in x's dtype."""
    return conv2d_gemm_nhwc(x, w.to(x.dtype), stride=(1, 1), padding=(1, 1))


def _padded_channels(c: int) -> int:
    """The channel count the bf16 kernel takes for ``c``: the next
    multiple of 8 (TMA's 16-byte row stride), at least 16."""
    return max(16, -(-c // 8) * 8)


def _pad_channels(x: torch.Tensor, wk: torch.Tensor):
    """NHWC ``x`` and (3, 3, out, in) ``wk`` with their input channels
    zero-padded to ``_padded_channels``: the zero channels add nothing,
    so the conv is unchanged.  Returns them as they are where no pad is
    needed."""
    pad = _padded_channels(x.shape[-1]) - x.shape[-1]
    if pad == 0:
        return x, wk
    return F.pad(x, (0, pad)), F.pad(wk, (0, pad))


def _conv3x3_cuda(x: torch.Tensor, wk: torch.Tensor) -> torch.Tensor:
    """Launch K5 on the current stream of x's device: NHWC ``x`` and
    weights ``wk`` as (3, 3, out, in), both contiguous in one dtype."""
    if x.dtype not in _DTYPE_CODE or wk.dtype != x.dtype:
        raise TypeError(f"conv3x3: x {x.dtype} and weights {wk.dtype} must "
                        f"share a dtype in {tuple(_DTYPE_CODE)}")
    if not (x.is_contiguous() and wk.is_contiguous()):
        raise ValueError("conv3x3: inputs must be contiguous")
    B, H, W, C = x.shape
    O = wk.shape[2]
    if wk.shape != (3, 3, O, C):
        raise ValueError(f"conv3x3: weights {tuple(wk.shape)} do not match "
                         f"x {tuple(x.shape)}")
    if wk.data_ptr() % 16:
        raise ValueError("conv3x3: weights must be 16-byte aligned")
    y = torch.empty((B, H, W, O), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    if x.dtype == torch.bfloat16 and (_padded_channels(C) != C
                                      or x.data_ptr() % 16):
        x, wk = _pad_channels(x, wk)
        if x.data_ptr() % 16:
            x = x.clone()
        C = x.shape[-1]
        X_COPIES.add()
    fn = load_cuda_library("conv3x3").bigdl_conv3x3
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), wk.data_ptr(), y.data_ptr(), B, H, W, C, O,
                 _DTYPE_CODE[x.dtype], int(x.data_ptr() % 16 == 0),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 launch failed: cudaError {err}")
    LAUNCHES.add()
    return y


def _conv3x3_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dW (3, 3, C, O) = Σ over b, h, w of x[b, h + dy − 1, w + dx − 1]ᵀ
    g[b, h, w], products in x's dtype with f32 accumulation.

    Two copies in all: x zero-padded to (B + 1, H + 2, W + 2, C) and g to
    (B, H + 2, W + 2, O), zero outside [:H, :W], both flattened to rows.
    Row i of g is pixel (b, h, w) and row i + dy·(W + 2) + dx of x its tap
    (dy, dx), so each tap is one contiguous window of x's rows times all of
    g's; a row that would cross into a pad column or the next image meets
    a zero row of g, and the zero image at the end keeps every window in
    range.  The extra work is (H + 2)(W + 2) / HW of the products."""
    B, H, W, C = x.shape
    Wp = W + 2
    n = B * (H + 2) * Wp
    xf = F.pad(x, (0, 0, 1, 1, 1, 1, 0, 1)).reshape(-1, C)
    gf = F.pad(g.to(x.dtype), (0, 0, 0, 2, 0, 2)).reshape(n, -1)
    dw = x.new_empty((3, 3, C, gf.shape[1]))
    for dy in range(3):
        for dx in range(3):
            off = dy * Wp + dx
            torch.mm(xf[off:off + n].t(), gf, out=dw[dy, dx])
    return dw


class _Conv3x3(torch.autograd.Function):
    """The ``custom_vjp`` of the TPU ``_conv3x3``: K5 forward; dX by K5
    on the flipped, transposed weights; dW by nine matmuls."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if on_cpu(x, w):
            return _conv3x3_plain(x, w)
        # (3, 3, C, O) -> (tap, out, in): one small copy per call
        return _conv3x3_cuda(x.contiguous(),
                             w.to(x.dtype).permute(0, 1, 3, 2).contiguous())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = g.to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # the dX conv's HWIO weights are w[::-1, ::-1] with in and
            # out swapped, so as (tap, out, in) they are w[::-1, ::-1]
            w_flip = w.to(x.dtype).flip(0, 1)
            if on_cpu(x, w, g):
                dx = _conv3x3_plain(gx, w_flip.transpose(2, 3))
            else:
                dx = _conv3x3_cuda(gx.contiguous(), w_flip.contiguous())
        if ctx.needs_input_grad[1]:
            dw = _conv3x3_dw(x, gx).to(w.dtype)
        return dx, dw


def conv3x3_s1_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3×3 stride-1 SAME NHWC conv through K5 (the plain version for CPU
    tensors); differentiable in x and w.

    x: [B, H, W, C]; w: [3, 3, C, O] (HWIO).  Returns [B, H, W, O] in
    x's dtype (f32 accumulation)."""
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3) \
            or w.shape[2] != x.shape[3]:
        raise ValueError(f"conv3x3_s1_same: x {tuple(x.shape)} (NHWC) and w "
                         f"{tuple(w.shape)} (3, 3, C, O) disagree")
    return _Conv3x3.apply(x, w)
