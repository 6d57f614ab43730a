"""The 3×3 stride-1 SAME convolution, forward and backward (counterpart
of ``bigdl_tpu/ops/conv3x3_pallas.py``; the name drops "pallas", since
nothing here is Pallas).

Kernel K5, CUDA C++ for ``sm_90a`` (``csrc/conv3x3.cu``, whose header
says what it computes, what bounds it and how), replaces ``_kernel``
(``bigdl_tpu/ops/conv3x3_pallas.py:60``).

``conv3x3_s1_same(x, w)`` takes NHWC ``x`` and HWIO ``w``, as the JAX
entry point does, and runs one ``torch.autograd.Function``, the
counterpart of that module's ``custom_vjp``:

* forward: K5 on ``x`` and the weights laid out (tap, out, in), f32
  accumulation, the output in x's dtype;
* backward: dX is K5 again, on the output gradient (cast to x's dtype)
  with the spatially flipped, in/out-transposed weights; dW is nine
  products (B·H·W, C)ᵀ × (B·H·W, O) of shifted slices of the padded x
  with the gradient, as the JAX package leaves them to XLA.

For CPU tensors the same Function runs the plain version,
``_conv3x3_plain`` (the nine shifted products of ``ops/conv_gemm.py``
with f32 accumulation), forward and dX; a CUDA tensor launches K5 or
raises.  Any B, H, W, C and O: the kernel masks the halo and every
ragged edge, bfloat16 or float32.
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


def _conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K5's math: NHWC ``x`` and HWIO ``w``, nine shifted products with
    f32 accumulation, the output in x's dtype."""
    return conv2d_gemm_nhwc(x, w.to(x.dtype), stride=(1, 1), padding=(1, 1))


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
    """dW (3, 3, C, O): for each tap, the shifted slice of the padded x,
    flattened to (B·H·W, C), transposed, times g flattened to
    (B·H·W, O); products in x's dtype with f32 accumulation."""
    B, H, W, C = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    gf = g.to(x.dtype).reshape(B * H * W, -1)
    taps = [torch.matmul(xp[:, dy:dy + H, dx:dx + W, :].reshape(-1, C).t(),
                         gf)
            for dy in range(3) for dx in range(3)]
    return torch.stack(taps).reshape(3, 3, C, gf.shape[1])


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
